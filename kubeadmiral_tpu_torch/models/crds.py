"""CRD manifests for the kubeadmiral API surface.

A copy of ``kubeadmiral_tpu/models/crds.py``.  The definitions live here
as code; ``config/crds/*.yaml`` are the JAX package's generated artifacts
(``python -m kubeadmiral_tpu.models.crds``), which this copy reproduces
byte for byte, kept in-repo like the reference's ``config/crds/*.yaml`` (reference:
pkg/apis/core/v1alpha1/*.go + generated manifests).  ``install`` creates
the CRD objects on a host apiserver, and ``crd_for_ftc`` generates the
federated-object CRD for a FederatedTypeConfig the way
``--create-crds-for-ftcs`` does (reference:
pkg/controllers/federatedtypeconfig/federatedtypeconfig_controller.go:437-520).
"""

from __future__ import annotations

import os

GROUP = "core.kubeadmiral.io"
VERSION = "v1alpha1"
TYPES_GROUP = "types.kubeadmiral.io"
CRD_RESOURCE = "apiextensions.k8s.io/v1/customresourcedefinitions"

_ANY = {"x-kubernetes-preserve-unknown-fields": True}
_STR = {"type": "string"}
_INT = {"type": "integer"}
_BOOL = {"type": "boolean"}


def _obj(props: dict, required: list[str] | None = None) -> dict:
    out = {"type": "object", "properties": props}
    if required:
        out["required"] = required
    return out


def _arr(items: dict) -> dict:
    return {"type": "array", "items": items}


_SELECTOR_TERM = _obj(
    {
        "matchExpressions": _arr(
            _obj({"key": _STR, "operator": _STR, "values": _arr(_STR)})
        ),
        "matchFields": _arr(
            _obj({"key": _STR, "operator": _STR, "values": _arr(_STR)})
        ),
    }
)

_TOLERATION = _obj(
    {
        "key": _STR,
        "operator": _STR,
        "value": _STR,
        "effect": _STR,
        "tolerationSeconds": _INT,
    }
)

_POLICY_SPEC = _obj(
    {
        "schedulingMode": {"type": "string", "enum": ["Duplicate", "Divide"]},
        "stickyCluster": _BOOL,
        "clusterSelector": {"type": "object", "additionalProperties": _STR},
        "clusterAffinity": _arr(_SELECTOR_TERM),
        "tolerations": _arr(_TOLERATION),
        "maxClusters": _INT,
        "placement": _arr(
            _obj(
                {
                    "cluster": _STR,
                    "preferences": _obj(
                        {
                            "minReplicas": _INT,
                            "maxReplicas": _INT,
                            "weight": _INT,
                        }
                    ),
                },
                required=["cluster"],
            )
        ),
        "schedulingProfile": _STR,
        "disableFollowerScheduling": _BOOL,
        "autoMigration": _obj(
            {
                "when": _obj({"podUnschedulableFor": _STR}),
                "keepUnschedulableReplicas": _BOOL,
            }
        ),
        "replicaRescheduling": _obj({"avoidDisruption": _BOOL}),
    }
)

_OVERRIDE_SPEC = _obj(
    {
        "overrideRules": _arr(
            _obj(
                {
                    "targetClusters": _obj(
                        {
                            "clusters": _arr(_STR),
                            "clusterSelector": {
                                "type": "object",
                                "additionalProperties": _STR,
                            },
                            "clusterAffinity": _arr(_SELECTOR_TERM),
                        }
                    ),
                    "overriders": _obj(
                        {
                            "jsonpatch": _arr(
                                _obj(
                                    {
                                        "operator": _STR,
                                        "path": _STR,
                                        "value": _ANY,
                                    },
                                    required=["path"],
                                )
                            )
                        }
                    ),
                }
            )
        )
    }
)

_FTC_SPEC = _obj(
    {
        "sourceType": _obj(
            {"group": _STR, "version": _STR, "kind": _STR, "pluralName": _STR,
             "scope": _STR},
            required=["version", "kind", "pluralName"],
        ),
        "federatedType": _obj(
            {"group": _STR, "version": _STR, "kind": _STR, "pluralName": _STR,
             "scope": _STR},
        ),
        "statusType": _obj(
            {"group": _STR, "version": _STR, "kind": _STR, "pluralName": _STR,
             "scope": _STR},
        ),
        "controllers": _arr(_arr(_STR)),
        "pathDefinition": _obj(
            {
                "replicasSpec": _STR,
                "replicasStatus": _STR,
                "availableReplicasStatus": _STR,
                "readyReplicasStatus": _STR,
                "labelSelector": _STR,
            }
        ),
        "statusCollection": _obj({"enabled": _BOOL, "fields": _arr(_STR)}),
        "statusAggregation": _STR,
        "revisionHistory": _STR,
        "rolloutPlan": _STR,
        "autoMigration": _obj({"enabled": _BOOL}),
    }
)

_PLUGIN_SET = _obj(
    {
        "enabled": _arr(_obj({"name": _STR}, required=["name"])),
        "disabled": _arr(_obj({"name": _STR}, required=["name"])),
    }
)


def crd(
    kind: str,
    plural: str,
    scope: str,
    spec_schema: dict,
    group: str = GROUP,
    version: str = VERSION,
    status: bool = True,
) -> dict:
    schema_props: dict = {
        "apiVersion": _STR,
        "kind": _STR,
        "metadata": {"type": "object"},
        "spec": spec_schema,
    }
    if status:
        schema_props["status"] = _ANY
    versions = [
        {
            "name": version,
            "served": True,
            "storage": True,
            "schema": {"openAPIV3Schema": _obj(schema_props)},
        }
    ]
    if status:
        versions[0]["subresources"] = {"status": {}}
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": kind.lower(),
            },
            "scope": scope,
            "versions": versions,
        },
    }


def core_crds() -> list[dict]:
    return [
        crd("FederatedTypeConfig", "federatedtypeconfigs", "Cluster", _FTC_SPEC),
        crd(
            "FederatedCluster",
            "federatedclusters",
            "Cluster",
            _obj(
                {
                    "apiEndpoint": _STR,
                    "secretRef": _obj({"name": _STR}),
                    "insecure": _BOOL,
                    "useServiceAccountToken": _BOOL,
                    "taints": _arr(
                        _obj({"key": _STR, "value": _STR, "effect": _STR})
                    ),
                }
            ),
        ),
        crd("PropagationPolicy", "propagationpolicies", "Namespaced", _POLICY_SPEC),
        crd(
            "ClusterPropagationPolicy",
            "clusterpropagationpolicies",
            "Cluster",
            _POLICY_SPEC,
        ),
        crd("OverridePolicy", "overridepolicies", "Namespaced", _OVERRIDE_SPEC),
        crd(
            "ClusterOverridePolicy",
            "clusteroverridepolicies",
            "Cluster",
            _OVERRIDE_SPEC,
        ),
        crd(
            "SchedulingProfile",
            "schedulingprofiles",
            "Cluster",
            _obj(
                {
                    "plugins": _obj(
                        {
                            "filter": _PLUGIN_SET,
                            "score": _PLUGIN_SET,
                            "select": _PLUGIN_SET,
                        }
                    )
                }
            ),
            status=False,
        ),
        crd(
            "SchedulerPluginWebhookConfiguration",
            "schedulerpluginwebhookconfigurations",
            "Cluster",
            _obj(
                {
                    "urlPrefix": _STR,
                    "filterPath": _STR,
                    "scorePath": _STR,
                    "selectPath": _STR,
                    "payloadVersions": _arr(_STR),
                    "httpTimeout": _STR,
                    "tlsConfig": _ANY,
                },
                required=["urlPrefix", "payloadVersions"],
            ),
            status=False,
        ),
        crd(
            "PropagatedVersion",
            "propagatedversions",
            "Namespaced",
            _ANY,
        ),
        crd(
            "ClusterPropagatedVersion",
            "clusterpropagatedversions",
            "Cluster",
            _ANY,
        ),
    ]


def crd_for_ftc(ftc) -> dict:
    """The federated-object CRD a FederatedTypeConfig implies."""
    fed = ftc.federated
    spec_schema = _obj(
        {
            "template": _ANY,
            "placements": _arr(
                _obj(
                    {
                        "controller": _STR,
                        "placement": _arr(
                            _obj({"cluster": _STR}, required=["cluster"])
                        ),
                    },
                    required=["controller"],
                )
            ),
            "overrides": _arr(
                _obj(
                    {
                        "controller": _STR,
                        "override": _arr(
                            _obj(
                                {
                                    "clusters": _arr(_STR),
                                    "patches": _arr(_ANY),
                                }
                            )
                        ),
                    }
                )
            ),
            "follows": _arr(
                _obj({"group": _STR, "kind": _STR, "name": _STR,
                      "namespace": _STR})
            ),
        }
    )
    group, version, plural = fed.resource.split("/")
    scope = "Namespaced" if ftc.namespaced else "Cluster"
    return crd(fed.kind, plural, scope, spec_schema, group=group, version=version)


def install(store, ftcs=()) -> int:
    """Create CRD objects on a host apiserver (idempotent); with ftcs,
    also the implied federated-object CRDs (--create-crds-for-ftcs)."""
    from kubeadmiral_tpu_torch.testing.fakekube import AlreadyExists

    n = 0
    for manifest in core_crds() + [crd_for_ftc(f) for f in ftcs]:
        try:
            store.create(CRD_RESOURCE, manifest)
            n += 1
        except AlreadyExists:
            pass
    return n


MANIFEST_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "config",
    "crds",
)


def write_manifests(directory: str = MANIFEST_DIR) -> list[str]:
    import yaml

    class _Dumper(yaml.SafeDumper):
        def ignore_aliases(self, data):  # no &id anchors in manifests
            return True

    os.makedirs(directory, exist_ok=True)
    paths = []
    for manifest in core_crds():
        name = manifest["metadata"]["name"]
        path = os.path.join(directory, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.dump(manifest, f, Dumper=_Dumper, sort_keys=False)
        paths.append(path)
    return paths


if __name__ == "__main__":
    # ``python -m kubeadmiral_tpu_torch.models.crds DIR``: the directory
    # is required, so the port never rewrites the JAX package's
    # MANIFEST_DIR by default.
    import sys

    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m kubeadmiral_tpu_torch.models.crds DIR")
    for p in write_manifests(sys.argv[1]):
        print(p)
