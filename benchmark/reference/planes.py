"""Filter and score planes of a block of object records against the clusters.

The plain reference's first half: the scheduler's Filter and Score plugins
(upstream ``pkg/controllers/scheduler/framework/plugins``) evaluated from
the benchmark's records, vectorised over [rows, clusters] with numpy.
Patterns: ``kubeadmiral_tpu/ops/pipeline_oracle.py`` (``_fits``,
``_balanced``, ``_ratio``, ``_normalize``, ``_filter_reasons``,
``_totals``) and the label semantics of ``kubeadmiral_tpu/utils/labels.py``,
as of commit 5df33979f11fc4d3c609bdae8857b52774b11979.  Imports nothing of
the program.

``itype`` is the integer type every resource quantity and score is held
and computed in: int64 as the configurations state; the control narrows
it to int32 (``benchmark/control.py``).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import fnv

MAX_SCORE = 100
FIXED = ("cpu", "memory")
IGNORED = ("ephemeral-storage",)  # neither a fixed nor a scalar column
DEFAULT_SCORES = (
    "TaintToleration",
    "ClusterResourcesBalancedAllocation",
    "ClusterResourcesLeastAllocated",
    "ClusterAffinity",
)


class Clusters:
    """Per-cluster tables of one cluster list."""

    def __init__(self, records):
        self.records = list(records)
        self.names = [c["name"] for c in self.records]
        self.index = {n: j for j, n in enumerate(self.names)}
        c = len(self.records)
        res = set()
        for r in self.records:
            res.update(r["alloc"])
            res.update(r["avail"])
        self.alloc = {k: np.array([r["alloc"].get(k, 0) for r in self.records], np.int64)
                      for k in sorted(res | set(FIXED))}
        self.avail = {k: np.array([r["avail"].get(k, 0) for r in self.records], np.int64)
                      for k in self.alloc}
        # Quantity.Value(): cores rounded up (rsp.go's dynamic weights).
        self.cpu_alloc = -(-self.alloc["cpu"] // 1000)
        self.cpu_avail = -(-self.avail["cpu"] // 1000)
        self.name_state = np.array([fnv.fnv32(n.encode()) for n in self.names], np.uint32)
        self.n = c

    def quantity(self, which: str, res: str, itype) -> np.ndarray:
        table = self.alloc if which == "alloc" else self.avail
        v = table.get(res)
        return np.zeros(self.n, itype) if v is None else v.astype(itype)


def _match_req(labels: dict, key: str, op: str, values) -> bool:
    has = key in labels
    value = labels.get(key)
    if op == "In":
        return has and value in values
    if op == "NotIn":
        return not has or value not in values
    if op == "Exists":
        return has
    if op == "DoesNotExist":
        return not has
    if op in ("Gt", "Lt"):
        if not has or len(values) != 1:
            return False
        try:
            lhs, rhs = int(value), int(values[0])
        except ValueError:
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    raise ValueError(f"invalid selector operator {op!r}")


def _match_term(labels, term) -> bool:
    # An empty term matches nothing; expressions are ANDed.
    return bool(term) and all(_match_req(labels, k, op, v) for k, op, v in term)


def _selector_row(cl: Clusters, aff) -> np.ndarray:
    if aff is None or aff["required"] is None:
        return np.ones(cl.n, bool)
    return np.array([any(_match_term(r["labels"], t) for t in aff["required"])
                     for r in cl.records], bool)


def _preferred_row(cl: Clusters, aff) -> np.ndarray:
    out = np.zeros(cl.n, np.int64)
    if aff is None:
        return out
    for weight, term in aff["preferred"]:
        if weight == 0 or not term:
            continue
        out += weight * np.array([_match_term(r["labels"], term) for r in cl.records], np.int64)
    return out


def _tolerates(tol, taint) -> bool:
    key, op, value, effect = tol
    t_key, t_value, t_effect = taint
    if effect and effect != t_effect:
        return False
    if key and key != t_key:
        return False
    if op == "Exists":
        return value == ""
    return value == t_value


def _taint_rows(cl: Clusters, tols) -> tuple[np.ndarray, np.ndarray]:
    """(ok, prefer_count) over the clusters for one toleration list: a
    NoSchedule or NoExecute taint no toleration tolerates rejects; each
    PreferNoSchedule taint no empty-effect or PreferNoSchedule toleration
    tolerates counts."""
    prefer_tols = [t for t in tols if not t[3] or t[3] == "PreferNoSchedule"]
    ok = np.ones(cl.n, bool)
    count = np.zeros(cl.n, np.int64)
    for j, r in enumerate(cl.records):
        for taint in r["taints"]:
            if taint[2] in ("NoSchedule", "NoExecute") and not any(
                _tolerates(t, taint) for t in tols
            ):
                ok[j] = False
            if taint[2] == "PreferNoSchedule" and not any(
                _tolerates(t, taint) for t in prefer_tols
            ):
                count[j] += 1
    return ok, count


class Memo:
    """Per-cluster-list rows shared by many records (toleration lists,
    affinities, GVKs), matched once for each distinct value."""

    def __init__(self, cl: Clusters):
        self.cl = cl
        self._rows: dict = {}

    def get(self, kind: str, part, build):
        key = (kind, repr(part))
        row = self._rows.get(key)
        if row is None:
            row = build(self.cl, part)
            self._rows[key] = row
        return row


def _api_row(cl: Clusters, gvk: str) -> np.ndarray:
    return np.array([gvk in r["api"] for r in cl.records], bool)


def _shift(cap: np.ndarray, itype) -> np.ndarray:
    """The smallest multiple-of-8 shift with (cap >> s) < 2^26: the exact
    balanced score's range reduction (thresholds past the type's range
    never hold)."""
    s = np.zeros(cap.shape, itype)
    top = np.iinfo(itype).max
    for k in range(5):
        t = 1 << (26 + 8 * k)
        if t > top:
            break
        s += (8 * (cap >= t)).astype(itype)
    return s


def _normalize(scores, feasible, reverse: bool, itype):
    masked = np.where(feasible, scores, 0).astype(itype)
    mx = masked.max(axis=1, keepdims=True)
    scaled = (MAX_SCORE * masked) // np.maximum(mx, 1)
    if reverse:
        return np.where(mx == 0, MAX_SCORE, MAX_SCORE - scaled).astype(itype)
    return np.where(mx == 0, masked, scaled).astype(itype)


class Block:
    """The planes of rows ``records`` against ``cl``: feasibility and the
    enabled scores' normalised totals (0 where infeasible)."""

    def __init__(self, records, cl: Clusters, memo: Memo, itype=np.int64):
        b, c = len(records), cl.n
        self.records = records
        api = np.stack([memo.get("api", r["gvk"], _api_row) for r in records]) if b else np.zeros((0, c), bool)
        taint = [memo.get("taint", r["tolerations"], _taint_rows) for r in records]
        taint_ok = np.stack([t[0] for t in taint]) if b else np.zeros((0, c), bool)
        self.taint_counts = np.stack([t[1] for t in taint]).astype(itype) if b else np.zeros((0, c), itype)
        selector = np.stack([memo.get("sel", r["affinity"], _selector_row) for r in records]) if b else np.zeros((0, c), bool)
        self.affinity_scores = (
            np.stack([memo.get("pref", r["affinity"], _preferred_row) for r in records]).astype(itype)
            if b else np.zeros((0, c), itype)
        )
        scalars = sorted({k for r in records for k in r["request"]} - set(FIXED) - set(IGNORED))
        self.resources = list(FIXED) + scalars
        self.request = np.array(
            [[r["request"].get(k, 0) for k in self.resources] for r in records], np.int64
        ).reshape(b, len(self.resources)).astype(itype)
        self.alloc = np.stack([cl.quantity("alloc", k, itype) for k in self.resources], 1)
        self.used = (self.alloc - np.stack([cl.quantity("avail", k, itype) for k in self.resources], 1)).astype(itype)

        # ClusterResourcesFit: cpu and memory always once anything is
        # requested, a scalar only where requested; nothing requested fits.
        free_ok = self.alloc[None, :, :] >= self.request[:, None, :] + self.used[None, :, :]
        scalar_ok = free_ok[:, :, 2:] | ~(self.request[:, None, 2:] > 0)
        fit = free_ok[:, :, 0] & free_ok[:, :, 1] & scalar_ok.all(axis=2)
        fit |= (self.request <= 0).all(axis=1)[:, None]
        self.fit = fit
        self.feasible = api & taint_ok & fit & selector
        self.api, self.taint_ok, self.selector = api, taint_ok, selector

        enabled = [set(r["scores"] if r["scores"] is not None else DEFAULT_SCORES) for r in records]
        self.score_enabled = np.array([[
            "TaintToleration" in e,
            "ClusterResourcesBalancedAllocation" in e,
            "ClusterResourcesLeastAllocated" in e,
            "ClusterAffinity" in e,
            "ClusterResourcesMostAllocated" in e,
        ] for e in enabled], bool).reshape(b, 5)
        self.totals = self._totals(itype)

    def _totals(self, itype):
        f = self.feasible
        ac = np.broadcast_to(self.alloc[None, :, 0], f.shape)
        am = np.broadcast_to(self.alloc[None, :, 1], f.shape)
        rc = (self.used[None, :, 0] + self.request[:, None, 0]).astype(itype)
        rm = (self.used[None, :, 1] + self.request[:, None, 1]).astype(itype)
        total = np.zeros(f.shape, itype)
        en = self.score_enabled
        if en[:, 0].any():
            total += np.where(en[:, 0:1], _normalize(self.taint_counts, f, True, itype), 0).astype(itype)
        if en[:, 1].any():
            total += np.where(en[:, 1:2], self.balanced(ac, am, rc, rm, itype), 0).astype(itype)
        if en[:, 2].any():
            total += np.where(en[:, 2:3], self.ratio(ac, am, rc, rm, True, itype), 0).astype(itype)
        if en[:, 3].any():
            total += np.where(en[:, 3:4], _normalize(self.affinity_scores, f, False, itype), 0).astype(itype)
        if en[:, 4].any():
            total += np.where(en[:, 4:5], self.ratio(ac, am, rc, rm, False, itype), 0).astype(itype)
        return np.where(f, total, 0).astype(itype)

    @staticmethod
    def balanced(ac, am, rc, rm, itype):
        """(1 - |cpuFraction - memFraction|) * 100 as the exact rational
        |rc*am - rm*ac| / (ac*am), operands range-shifted; 0 where either
        fraction reaches 1."""
        zero = (ac == 0) | (am == 0) | (rc >= ac) | (rm >= am)
        sc, sm = _shift(ac, itype), _shift(am, itype)
        a_c, r_c = ac >> sc, rc >> sc
        a_m, r_m = am >> sm, rm >> sm
        tot = np.maximum(a_c * a_m, 1).astype(itype)
        diff = np.abs(r_c * a_m - r_m * a_c).astype(itype)
        return np.where(zero, 0, (MAX_SCORE * (tot - diff)) // tot).astype(itype)

    @staticmethod
    def ratio(ac, am, rc, rm, least: bool, itype):
        out = np.zeros(rc.shape, itype)
        for cap, req in ((ac, rc), (am, rm)):
            num = (cap - req) if least else req
            s = (num * MAX_SCORE) // np.maximum(cap, 1)
            out += np.where((cap == 0) | (req > cap), 0, s).astype(itype)
        return (out // 2).astype(itype)
