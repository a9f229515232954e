"""Featurizer: API objects -> numpy planes for the dense tick.

A numpy copy of ``kubeadmiral_tpu/scheduler/featurize.py`` that builds
the port's ``TickInputs`` (as numpy arrays; ``convert.py`` moves them to
a device).

The string-matching world (taints/tolerations, label selectors, affinity
terms, API resource lists) is resolved host-side into boolean/integer
tensors; the trick that keeps this off the critical path is **dedup +
gather**: objects share a handful of distinct toleration sets, selector
specs and policies, and clusters share a handful of taint/label sets, so
each distinct pair is matched once into a small matrix and then gathered
into [B, C] with numpy advanced indexing.  Only the planner tie-break
hash is inherently per-(object, cluster); its rows are cached by object
key since they change only when the cluster set changes.

This replaces the reference's per-object, per-cluster, per-plugin Go
call chain (reference: pkg/controllers/scheduler/framework/runtime/
framework.go:114-181) with O(unique pairs) host work + one device gather.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.ops import filters as OF
from kubeadmiral_tpu_torch.ops import scores as OS
from kubeadmiral_tpu_torch.ops.pipeline import NIL_REPLICAS, TickInputs
from kubeadmiral_tpu_torch.ops.planner import INT32_INF, validate_ranges
from kubeadmiral_tpu_torch.utils import labels as L
from kubeadmiral_tpu_torch.utils.hashing import (
    fnv32,
    fnv32_extend,
    uint32_to_sortable_int32,
)

_FILTER_INDEX = {
    T.APIRESOURCES: OF.F_API_RESOURCES,
    T.TAINT_TOLERATION: OF.F_TAINT_TOLERATION,
    T.CLUSTER_RESOURCES_FIT: OF.F_RESOURCES_FIT,
    T.PLACEMENT_FILTER: OF.F_PLACEMENT,
    T.CLUSTER_AFFINITY: OF.F_CLUSTER_AFFINITY,
}
_SCORE_INDEX = {
    T.TAINT_TOLERATION: OS.S_TAINT,
    T.CLUSTER_RESOURCES_BALANCED: OS.S_BALANCED,
    T.CLUSTER_RESOURCES_LEAST: OS.S_LEAST,
    T.CLUSTER_AFFINITY: OS.S_AFFINITY,
    T.CLUSTER_RESOURCES_MOST: OS.S_MOST,
}


class ClusterView:
    """Per-tick tensor view of the member clusters.

    Build once per tick (cluster state changes far less often than
    objects); reused across every batch chunk.
    """

    def __init__(self, clusters: Sequence[T.ClusterState], scalar_resources: Sequence[str] = ()):
        self.clusters = list(clusters)
        self.names = [c.name for c in self.clusters]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.scalar_resources = list(scalar_resources)
        c = len(self.clusters)
        r = OF.NUM_FIXED_RESOURCES + len(self.scalar_resources)

        self.alloc = np.zeros((c, r), np.int64)
        self.avail = np.zeros((c, r), np.int64)
        self.cpu_alloc = np.zeros(c, np.int64)
        self.cpu_avail = np.zeros(c, np.int64)
        for i, cl in enumerate(self.clusters):
            self.alloc[i] = self._res_row(cl.allocatable, r)
            self.avail[i] = self._res_row(cl.available, r)
            # Quantity.Value() semantics: cores rounded up (rsp.go weights).
            self.cpu_alloc[i] = -(-cl.allocatable.get("cpu", 0) // 1000)
            self.cpu_avail[i] = -(-cl.available.get("cpu", 0) // 1000)
        self.used = self.alloc - self.avail

        # Dedup ids for taint sets and label sets.
        self.taint_sets: list[tuple[T.Taint, ...]] = []
        taint_ids: dict[tuple[T.Taint, ...], int] = {}
        self.taint_id = np.zeros(c, np.int64)
        for i, cl in enumerate(self.clusters):
            key = tuple(cl.taints)
            if key not in taint_ids:
                taint_ids[key] = len(self.taint_sets)
                self.taint_sets.append(key)
            self.taint_id[i] = taint_ids[key]

        self.label_keys: list[frozenset] = []
        label_ids: dict[frozenset, int] = {}
        self.label_id = np.zeros(c, np.int64)
        for i, cl in enumerate(self.clusters):
            key = frozenset(cl.labels.items())
            if key not in label_ids:
                label_ids[key] = len(self.label_keys)
                self.label_keys.append(key)
            self.label_id[i] = label_ids[key]

        # FNV-1 state after hashing each cluster name (planner tie-breaks
        # extend this with the object key — hashing.fnv32_extend).
        self.name_hash_state = np.array(
            [fnv32(n.encode()) for n in self.names], np.uint32
        )
        self._tiebreak_cache: dict[str, np.ndarray] = {}

    @staticmethod
    def _res_row(res: dict[str, int], r: int) -> np.ndarray:
        row = np.zeros(r, np.int64)
        row[OF.R_CPU] = res.get("cpu", 0)
        row[OF.R_MEM] = res.get("memory", 0)
        return row

    def tiebreak_row(self, key: str) -> np.ndarray:
        row = self._tiebreak_cache.get(key)
        if row is None:
            row = uint32_to_sortable_int32(
                fnv32_extend(self.name_hash_state, key.encode())
            )
            self._tiebreak_cache[key] = row
        return row

    def tiebreak_rows(self, keys: list[str]) -> np.ndarray:
        """[len(keys), C] tie-break hashes; uncached keys are extended in
        one vectorized sweep over byte positions instead of per key."""
        c = len(self.names)
        out = np.empty((len(keys), c), np.int32)
        missing: dict[str, list[int]] = {}
        for i, key in enumerate(keys):
            row = self._tiebreak_cache.get(key)
            if row is None:
                missing.setdefault(key, []).append(i)
            else:
                out[i] = row
        if missing:
            uniq = list(missing)
            encoded = [k.encode() for k in uniq]
            max_len = max(len(e) for e in encoded)
            lens = np.array([len(e) for e in encoded])
            byte_mat = np.zeros((len(uniq), max_len), np.uint32)
            for j, e in enumerate(encoded):
                byte_mat[j, : len(e)] = np.frombuffer(e, np.uint8)
            states = np.broadcast_to(
                self.name_hash_state, (len(uniq), c)
            ).astype(np.uint32)
            prime = np.uint32(16777619)
            with np.errstate(over="ignore"):
                for p in range(max_len):
                    active = lens > p
                    if not active.all():
                        upd = states[active] * prime ^ byte_mat[active, p][:, None]
                        states[active] = upd
                    else:
                        states = states * prime ^ byte_mat[:, p][:, None]
            rows = uint32_to_sortable_int32(states)
            for j, k in enumerate(uniq):
                self._tiebreak_cache[k] = rows[j]
                for i in missing[k]:
                    out[i] = rows[j]
        return out


def featurize_signature(su: T.SchedulingUnit) -> tuple:
    """Equality-comparable digest of every unit field the featurizer
    reads (the reference's scheduling-trigger hash,
    scheduler/schedulingtriggers.go:106-148): two units with equal
    signatures featurize to identical rows against the same cluster
    topology, which lets the engine patch only changed rows into a
    cached chunk.

    Memoised on the unit as ``_featurize_sig``: a SchedulingUnit is
    immutable after construction, so the digest is computed once per
    object.  A caller that mutates a unit's nested dicts after the first
    call is not detected."""
    sig = getattr(su, "_featurize_sig", None)
    if sig is not None:
        return sig
    am = su.auto_migration
    sig = (
        su.key,
        su.gvk,
        su.scheduling_mode,
        su.desired_replicas,
        su.sticky_cluster,
        su.avoid_disruption,
        su.max_clusters,
        tuple(sorted(su.resource_request.items())),
        su.tolerations,
        tuple(sorted(su.cluster_selector.items())),
        su.cluster_names,
        su.affinity,
        tuple(sorted(su.current_clusters.items(), key=lambda kv: kv[0])),
        tuple(sorted(su.min_replicas.items())),
        tuple(sorted(su.max_replicas.items())),
        tuple(sorted(su.weights.items())),
        (am.keep_unschedulable_replicas, tuple(sorted(am.estimated_capacity.items())))
        if am is not None
        else None,
        su.enabled_filters,
        su.enabled_scores,
    )
    object.__setattr__(su, "_featurize_sig", sig)
    return sig


def _build_cluster_view(clusters, units) -> ClusterView:
    scalars: list[str] = []
    seen = set()
    for su in units:
        for name in su.resource_request:
            if name not in ("cpu", "memory", "ephemeral-storage") and name not in seen:
                seen.add(name)
                scalars.append(name)
    view = ClusterView(clusters, sorted(scalars))
    # Fill scalar columns.
    for i, cl in enumerate(view.clusters):
        for j, rname in enumerate(view.scalar_resources):
            col = OF.NUM_FIXED_RESOURCES + j
            view.alloc[i, col] = cl.allocatable.get(rname, 0)
            view.avail[i, col] = cl.available.get(rname, 0)
    view.used = view.alloc - view.avail
    return view


def _dedup(items, key_fn):
    ids, keys, uniq = [], {}, []
    for it in items:
        k = key_fn(it)
        if k not in keys:
            keys[k] = len(uniq)
            uniq.append(it)
        ids.append(keys[k])
    return np.array(ids, np.int64), uniq


@dataclass
class FeaturizedBatch:
    inputs: TickInputs
    units: list
    view: ClusterView


def featurize(
    units: Sequence[T.SchedulingUnit],
    clusters: Sequence[T.ClusterState],
    view: Optional[ClusterView] = None,
    webhook_eval=None,
) -> FeaturizedBatch:
    """Pack a batch of scheduling units against the member clusters.

    ``webhook_eval(unit, clusters) -> (ok_row, score_row) | None`` is the
    host-side hook for out-of-process scheduler plugins (reference:
    scheduler/extensions/webhook): their per-(object, cluster) HTTP
    results enter the fused tick as an extra mask and score plane."""
    units = list(units)
    if view is None:
        view = _build_cluster_view(clusters, units)
    b, c = len(units), len(view.clusters)
    r = view.alloc.shape[1]

    webhook_ok = np.ones((b, c), bool)
    webhook_scores = np.zeros((b, c), np.int32)
    if webhook_eval is not None:
        int32_info = np.iinfo(np.int32)
        for i, su in enumerate(units):
            result = webhook_eval(su, view.clusters)
            if result is not None:
                webhook_ok[i], scores_row = result
                # Free-form HTTP responses are clamped to int32: the
                # tick's score outputs travel as int32 to keep the
                # device->host transfer small, and an unclamped 2**31
                # webhook score would wrap.
                webhook_scores[i] = np.clip(
                    scores_row, int32_info.min // 2, int32_info.max // 2
                )

    # --- plugin enablement ---
    filter_enabled = np.zeros((b, OF.NUM_FILTER_PLUGINS), bool)
    score_enabled = np.zeros((b, OS.NUM_SCORE_PLUGINS), bool)
    for i, su in enumerate(units):
        for name in su.enabled_filters if su.enabled_filters is not None else T.DEFAULT_FILTERS:
            idx = _FILTER_INDEX.get(name)
            if idx is not None:
                filter_enabled[i, idx] = True
        for name in su.enabled_scores if su.enabled_scores is not None else T.DEFAULT_SCORES:
            idx = _SCORE_INDEX.get(name)
            if idx is not None:
                score_enabled[i, idx] = True

    # --- API resources: unique GVKs x clusters ---
    gvk_ids, gvks = _dedup(units, lambda su: su.gvk)
    api_matrix = np.zeros((len(gvks), c), bool)
    for gi, su in enumerate(gvks):
        for ci, cl in enumerate(view.clusters):
            api_matrix[gi, ci] = su.gvk in cl.api_resources
    api_ok = api_matrix[gvk_ids]

    # --- taints: unique toleration sets x unique taint sets ---
    tol_ids, tol_units = _dedup(units, lambda su: tuple(su.tolerations))
    u_tol, u_taint = len(tol_units), len(view.taint_sets)
    ok_new = np.ones((u_tol, u_taint), bool)
    ok_cur = np.ones((u_tol, u_taint), bool)
    prefer = np.zeros((u_tol, u_taint), np.int32)
    for ti, su in enumerate(tol_units):
        tols = su.tolerations
        prefer_tols = [t for t in tols if not t.effect or t.effect == T.PREFER_NO_SCHEDULE]
        for si, taints in enumerate(view.taint_sets):
            for taint in taints:
                tolerated = any(t.tolerates(taint) for t in tols)
                if not tolerated:
                    if taint.effect in (T.NO_SCHEDULE, T.NO_EXECUTE):
                        ok_new[ti, si] = False
                    if taint.effect == T.NO_EXECUTE:
                        ok_cur[ti, si] = False
                if taint.effect == T.PREFER_NO_SCHEDULE and not any(
                    t.tolerates(taint) for t in prefer_tols
                ):
                    prefer[ti, si] += 1
    taint_ok_new = ok_new[tol_ids][:, view.taint_id]
    taint_ok_cur = ok_cur[tol_ids][:, view.taint_id]
    taint_counts = prefer[tol_ids][:, view.taint_id]

    # --- selectors / affinity: unique specs x clusters ---
    def sel_key(su):
        aff = su.affinity
        req = aff.required if aff is not None else None
        return (frozenset(su.cluster_selector.items()), req)

    sel_ids, sel_units = _dedup(units, sel_key)
    sel_matrix = np.zeros((len(sel_units), c), bool)
    for si, su in enumerate(sel_units):
        memo: dict[tuple, bool] = {}
        uses_fields = su.affinity is not None and su.affinity.required and any(
            t.match_fields for t in su.affinity.required
        )
        for ci, cl in enumerate(view.clusters):
            mk = (view.label_id[ci], cl.name if uses_fields else "")
            if mk not in memo:
                memo[mk] = L.cluster_feasible(
                    cl.labels, cl.name, su.cluster_selector, su.affinity
                )
            sel_matrix[si, ci] = memo[mk]
    selector_ok = sel_matrix[sel_ids]

    def pref_key(su):
        return su.affinity.preferred if su.affinity is not None else ()

    pref_ids, pref_units = _dedup(units, pref_key)
    pref_matrix = np.zeros((len(pref_units), c), np.int32)
    for pi, su in enumerate(pref_units):
        if su.affinity is None or not su.affinity.preferred:
            continue
        memo = {}
        for ci, cl in enumerate(view.clusters):
            mk = view.label_id[ci]
            if mk not in memo:
                memo[mk] = L.preferred_score(cl.labels, cl.name, su.affinity)
            pref_matrix[pi, ci] = memo[mk]
    affinity_scores = pref_matrix[pref_ids]

    # --- explicit placements ---
    place_ids, place_units = _dedup(units, lambda su: su.cluster_names)
    place_matrix = np.zeros((len(place_units), c), bool)
    for pi, su in enumerate(place_units):
        for ci, n in enumerate(view.names):
            place_matrix[pi, ci] = n in su.cluster_names
    placement_ok = place_matrix[place_ids]
    placement_has = np.array([len(su.cluster_names) > 0 for su in units])

    # --- resources ---
    request = np.zeros((b, r), np.int64)
    for i, su in enumerate(units):
        request[i, OF.R_CPU] = su.resource_request.get("cpu", 0)
        request[i, OF.R_MEM] = su.resource_request.get("memory", 0)
        for j, rname in enumerate(view.scalar_resources):
            request[i, OF.NUM_FIXED_RESOURCES + j] = su.resource_request.get(rname, 0)

    # --- per-(object, cluster) policy grids ---
    def grid(get_map, dtype, fill):
        out = np.full((b, c), fill, dtype)
        for i, su in enumerate(units):
            m = get_map(su)
            for cname, v in m.items():
                ci = view.index.get(cname)
                if ci is not None:
                    out[i, ci] = v
        return out

    min_replicas = grid(lambda su: su.min_replicas, np.int32, 0)
    max_replicas = grid(lambda su: su.max_replicas, np.int32, INT32_INF)
    weights = grid(lambda su: su.weights, np.int32, 0)
    capacity = np.full((b, c), INT32_INF, np.int32)
    keep = np.zeros(b, bool)
    for i, su in enumerate(units):
        am = su.auto_migration
        if am is not None:
            keep[i] = am.keep_unschedulable_replicas
            for cname, cap in am.estimated_capacity.items():
                ci = view.index.get(cname)
                if ci is not None and cap >= 0:
                    capacity[i, ci] = cap

    current_mask = np.zeros((b, c), bool)
    current_replicas = np.full((b, c), NIL_REPLICAS, np.int32)
    for i, su in enumerate(units):
        for cname, reps in su.current_clusters.items():
            ci = view.index.get(cname)
            if ci is None:
                continue
            current_mask[i, ci] = True
            if reps is not None:
                current_replicas[i, ci] = reps

    tiebreak = view.tiebreak_rows([su.key for su in units]) if b else np.zeros((0, c), np.int32)

    total = np.array(
        [su.desired_replicas or 0 for su in units], np.int32
    )
    validate_ranges(total, weights.astype(np.int64))
    # Objects without static weights get dynamic RSP weights on device
    # (normalized to sum 1000, plus a rounding residual), so the planner's
    # int32 contract must also hold for an effective weight of ~2000.
    weights_given = np.array([len(su.weights) > 0 for su in units])
    dyn_totals = np.asarray(
        [su.desired_replicas or 0 for su, given in zip(units, weights_given) if not given],
        np.int64,
    )
    if dyn_totals.size and int(dyn_totals.max()) * 2048 >= 2**31:
        worst = max(
            (su for su, given in zip(units, weights_given) if not given),
            key=lambda su: su.desired_replicas or 0,
        )
        raise OverflowError(
            f"desired replicas {worst.desired_replicas} of {worst.key} exceeds "
            f"the planner's int32 range with dynamic weights (max ~1M replicas)"
        )

    inputs = TickInputs(
        filter_enabled=filter_enabled,
        api_ok=api_ok,
        taint_ok_new=taint_ok_new,
        taint_ok_cur=taint_ok_cur,
        selector_ok=selector_ok,
        placement_has=placement_has,
        placement_ok=placement_ok,
        request=request,
        alloc=view.alloc,
        used=view.used,
        score_enabled=score_enabled,
        taint_counts=taint_counts,
        affinity_scores=affinity_scores,
        webhook_ok=webhook_ok,
        webhook_scores=webhook_scores,
        max_clusters=np.array(
            [INT32_INF if su.max_clusters is None else su.max_clusters for su in units],
            np.int32,
        ),
        mode_divide=np.array(
            [su.scheduling_mode == T.MODE_DIVIDE for su in units]
        ),
        sticky=np.array([su.sticky_cluster for su in units]),
        current_mask=current_mask,
        current_replicas=current_replicas,
        total=total,
        weights_given=weights_given,
        weights=weights,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        scale_max=max_replicas.copy(),
        capacity=capacity,
        keep_unschedulable=keep,
        avoid_disruption=np.array([su.avoid_disruption for su in units]),
        tiebreak=tiebreak.astype(np.int32),
        cpu_alloc=view.cpu_alloc,
        cpu_avail=view.cpu_avail,
        cluster_valid=np.ones(c, bool),
    )
    return FeaturizedBatch(inputs=inputs, units=units, view=view)
