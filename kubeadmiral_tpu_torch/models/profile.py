"""SchedulingProfile: per-policy plugin enablement.

A copy of ``kubeadmiral_tpu/models/profile.py`` for the port's control
plane.

A SchedulingProfile selects which scheduler plugins run for objects bound
to a policy that names it (reference:
pkg/apis/core/v1alpha1/types_schedulingprofile.go, application logic
pkg/controllers/scheduler/profile.go:52-82).  Semantics per extension
point (filter / score / select):

* ``disabled`` removes default plugins by name; ``"*"`` removes all.
* ``enabled`` appends plugins after the surviving defaults.

In the batch engine the resolved plugin name lists become per-object
boolean enable masks over the fused tick's plugin axes
(ops.filters.F_* / ops.scores.S_*); disabling MaxCluster at the select
point lifts the top-K limit for that object.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubeadmiral_tpu_torch.models import types as T

SCHEDULING_PROFILES = "core.kubeadmiral.io/v1alpha1/schedulingprofiles"

DEFAULT_SELECTS: tuple[str, ...] = (T.MAX_CLUSTER,)


@dataclass(frozen=True)
class PluginSet:
    """Enabled/disabled plugin names for one extension point."""

    enabled: tuple[str, ...] = ()
    disabled: tuple[str, ...] = ()


@dataclass(frozen=True)
class ProfileSpec:
    name: str
    generation: int = 1
    # None means "extension point not specified" -> defaults untouched.
    filter: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    select: PluginSet = field(default_factory=PluginSet)


def _parse_plugin_set(raw: dict | None) -> PluginSet:
    raw = raw or {}
    return PluginSet(
        enabled=tuple(p.get("name", "") for p in raw.get("enabled") or ()),
        disabled=tuple(p.get("name", "") for p in raw.get("disabled") or ()),
    )


def parse_profile(obj: dict) -> ProfileSpec:
    """Unstructured SchedulingProfile -> ProfileSpec."""
    spec = obj.get("spec", {})
    plugins = spec.get("plugins") or {}
    return ProfileSpec(
        name=obj["metadata"]["name"],
        generation=obj["metadata"].get("generation", 1),
        filter=_parse_plugin_set(plugins.get("filter", {})),
        score=_parse_plugin_set(plugins.get("score", {})),
        select=_parse_plugin_set(plugins.get("select", {})),
    )


def reconcile_ext_point(
    defaults: tuple[str, ...], plugin_set: PluginSet
) -> tuple[str, ...]:
    """Apply one PluginSet to the default plugin list
    (profile.go reconcileExtPoint): drop disabled defaults ("*" drops
    all), then append enabled plugins."""
    disabled = set(plugin_set.disabled)
    result: list[str] = []
    if "*" not in disabled:
        result.extend(name for name in defaults if name not in disabled)
    result.extend(plugin_set.enabled)
    return tuple(result)


def resolve_plugins(
    profile: ProfileSpec | None,
) -> tuple[tuple[str, ...], tuple[str, ...], tuple[str, ...]]:
    """Resolved (filters, scores, selects) name lists for a profile
    (None -> defaults, matching GetDefaultEnabledPlugins)."""
    if profile is None:
        return T.DEFAULT_FILTERS, T.DEFAULT_SCORES, DEFAULT_SELECTS
    return (
        reconcile_ext_point(T.DEFAULT_FILTERS, profile.filter),
        reconcile_ext_point(T.DEFAULT_SCORES, profile.score),
        reconcile_ext_point(DEFAULT_SELECTS, profile.select),
    )
