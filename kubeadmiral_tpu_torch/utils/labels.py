"""Label/field selector matching with k8s semantics.

Mirrors the behavior the reference gets from k8s.io/apimachinery
labels.Requirement (reference usage: pkg/controllers/util/clusterselector/
util.go): NotIn and DoesNotExist match when the key is absent; Gt/Lt parse
the label value as an integer and require the key to exist.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

from kubeadmiral_tpu_torch.models.types import (
    ClusterAffinity,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SelectorTerm,
)


def match_requirement(labels: Mapping[str, str], req: SelectorRequirement) -> bool:
    has = req.key in labels
    value = labels.get(req.key)
    op = req.operator
    if op == "In":
        return has and value in req.values
    if op == "NotIn":
        return not has or value not in req.values
    if op == "Exists":
        return has
    if op == "DoesNotExist":
        return not has
    if op in ("Gt", "Lt"):
        if not has or len(req.values) != 1:
            return False
        try:
            lhs, rhs = int(value), int(req.values[0])
        except (TypeError, ValueError):
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    raise ValueError(f"invalid selector operator {op!r}")


def match_field_requirement(fields: Mapping[str, str], req: SelectorRequirement) -> bool:
    """Field selectors support only In/NotIn with a single value
    (clusterselector/util.go:64-97)."""
    value = fields.get(req.key, "")
    if len(req.values) != 1:
        return False
    if req.operator == "In":
        return value == req.values[0]
    if req.operator == "NotIn":
        return value != req.values[0]
    return False


def match_term(
    labels: Mapping[str, str], fields: Mapping[str, str], term: SelectorTerm
) -> bool:
    """Empty term matches nothing; expressions and fields are ANDed
    (clusterselector/util.go:99-140)."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not match_requirement(labels, req):
            return False
    for req in term.match_fields:
        if not match_field_requirement(fields, req):
            return False
    return True


def match_terms(
    labels: Mapping[str, str],
    fields: Mapping[str, str],
    terms: Sequence[SelectorTerm],
) -> bool:
    """Terms are ORed."""
    return any(match_term(labels, fields, t) for t in terms)


def matches_selector_set(labels: Mapping[str, str], selector: Mapping[str, str]) -> bool:
    """labels.SelectorFromSet: every key/value must match exactly."""
    return all(labels.get(k) == v for k, v in selector.items())


def cluster_feasible(
    labels: Mapping[str, str],
    name: str,
    selector: Mapping[str, str],
    affinity: Optional[ClusterAffinity],
) -> bool:
    """The ClusterAffinity filter plugin's decision
    (cluster_affinity.go:50-93): selector-set AND required terms."""
    if selector and not matches_selector_set(labels, selector):
        return False
    if affinity is not None and affinity.required is not None:
        if not match_terms(labels, {"metadata.name": name}, affinity.required):
            return False
    return True


def preferred_score(
    labels: Mapping[str, str],
    name: str,
    affinity: Optional[ClusterAffinity],
) -> int:
    """Sum of weights of matching preferred terms (cluster_affinity.go:96-124).

    Only matchExpressions participate (the reference builds a label selector
    from the preference's expressions; a term with no expressions matches
    everything via labels.Nothing()? No — an empty requirement list yields
    labels.Nothing(), which matches nothing)."""
    if affinity is None:
        return 0
    score = 0
    for term in affinity.preferred:
        if term.weight == 0:
            continue
        exprs = term.preference.match_expressions
        if not exprs:
            continue  # labels.Nothing() matches no clusters
        if all(match_requirement(labels, r) for r in exprs):
            score += term.weight
    return score
