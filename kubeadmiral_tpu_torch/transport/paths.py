"""Kubernetes-style REST path codec.

A copy of ``kubeadmiral_tpu/transport/paths.py`` for the port's control
plane.

Resource keys in this framework are ``group/version/plural`` (or
``version/plural`` for the core group), matching how the reference
addresses resources by GVR.  These map onto apiserver URL paths the same
way real Kubernetes lays them out:

    v1/pods, ns=default, name=web  ->  /api/v1/namespaces/default/pods/web
    apps/v1/deployments (all ns)   ->  /apis/apps/v1/deployments
    core.kubeadmiral.io/v1alpha1/federatedclusters, name=c1
        -> /apis/core.kubeadmiral.io/v1alpha1/federatedclusters/c1
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class ParsedPath(NamedTuple):
    resource: str
    namespace: Optional[str]  # None = cluster-scoped or all-namespace list
    name: Optional[str]
    subresource: Optional[str]


def resource_to_path(
    resource: str,
    namespace: Optional[str] = None,
    name: Optional[str] = None,
    subresource: Optional[str] = None,
) -> str:
    parts = resource.split("/")
    if len(parts) == 2:
        version, plural = parts
        base = f"/api/{version}"
    elif len(parts) == 3:
        group, version, plural = parts
        base = f"/apis/{group}/{version}"
    else:
        raise ValueError(f"bad resource key: {resource!r}")
    if namespace:
        base += f"/namespaces/{namespace}"
    base += f"/{plural}"
    if name:
        base += f"/{name}"
    if subresource:
        base += f"/{subresource}"
    return base


def key_to_path(
    resource: str, key: str, subresource: Optional[str] = None
) -> str:
    """Path for a store key ('ns/name' or 'name')."""
    if "/" in key:
        ns, name = key.split("/", 1)
    else:
        ns, name = None, key
    return resource_to_path(resource, ns, name, subresource)


def parse_path(path: str) -> ParsedPath:
    segs = [s for s in path.split("/") if s]
    if len(segs) >= 2 and segs[0] == "api":
        prefix = segs[1]  # version only (core group)
        rest = segs[2:]
    elif len(segs) >= 3 and segs[0] == "apis":
        prefix = f"{segs[1]}/{segs[2]}"
        rest = segs[3:]
    else:
        raise ValueError(f"unroutable path: {path!r}")
    if not rest:
        raise ValueError(f"no resource in path: {path!r}")

    namespace: Optional[str] = None
    if rest[0] == "namespaces" and len(rest) >= 3 and rest[2] != "status":
        # /…/namespaces/{ns}/{plural}[/{name}[/{sub}]]
        namespace = rest[1]
        rest = rest[2:]
    # else: operations on the namespaces resource itself
    # (/api/v1/namespaces[/{name}[/status]]) fall through with rest[0]
    # == "namespaces" as the plural.

    plural = rest[0]
    name = rest[1] if len(rest) >= 2 else None
    subresource = rest[2] if len(rest) >= 3 else None
    if len(rest) > 3:
        raise ValueError(f"path too deep: {path!r}")
    return ParsedPath(f"{prefix}/{plural}", namespace, name, subresource)
