"""The port's scheduler extension service against the JAX package's.

* The live cases of ``tests/test_webhook.py`` (an ``ExtensionService``
  serving filter and select end to end, the batch protocol's one POST
  per plugin per tick, the per-pair fallback of a reference-protocol
  server, an unsupported payload version) and all six cases of
  ``tests/test_webhook_tls.py`` (CA-verified, untrusted CA, insecure,
  server-name override, mutual TLS, a stalled client) on the port's
  service and client: the test modules' globals and the modules their
  cases import pointed at the port's, the scheduler on the CPU engine.
* The JAX package's webhook client against the port's service answers
  as it answers against the JAX service, per pair and batched, and the
  port's ``webhook_configuration`` equals the JAX one's.
"""

import pytest

import test_e2e_slice as E2E
import test_webhook as WH
import test_webhook_tls as TLS
from test_torch_transport import case_ids, run_on_port
from test_webhook_tls import pki  # noqa: F401 - the TLS cases' fixture

from kubeadmiral_tpu.models.types import ClusterState, SchedulingUnit, parse_resources
from kubeadmiral_tpu.scheduler import extension_service as jax_ext
from kubeadmiral_tpu.scheduler import webhook as jax_webhook
from kubeadmiral_tpu_torch.scheduler import extension_service as port_ext

LIVE_CASES = [
    (WH.TestWebhookScheduling, name)
    for name in (
        "test_live_extension_service_end_to_end",
        "test_batch_protocol_is_one_post_per_plugin_per_tick",
        "test_reference_protocol_server_falls_back_to_per_pair",
        "test_unsupported_payload_version_is_not_registered",
    )
]


@pytest.mark.parametrize("cls,name", LIVE_CASES, ids=case_ids(LIVE_CASES))
def test_webhook_live_case(monkeypatch, cls, name):
    run_on_port(monkeypatch, WH, cls, name, extra=(E2E,))


TLS_CASES = [(TLS.TestWebhookTLS, n) for n in sorted(vars(TLS.TestWebhookTLS)) if n.startswith("test_")]


@pytest.mark.parametrize("cls,name", TLS_CASES, ids=case_ids(TLS_CASES))
def test_webhook_tls_case(monkeypatch, pki, cls, name):  # noqa: F811
    run_on_port(monkeypatch, TLS, cls, name, fixtures={"pki": pki})


def test_six_tls_cases():
    assert len(TLS_CASES) == 6


def region_filter(req):
    return {"selected": req["cluster"]["metadata"]["labels"].get("region") == "eu"}


def name_score(req):
    return {"score": len(req["cluster"]["metadata"]["name"]) * 10 + len(req["schedulingUnit"]["name"])}


def first_select(req):
    return {"selectedClusterNames": sorted(cs["cluster"]["metadata"]["name"]
                                           for cs in req["clusterScores"])[:1]}


def units_and_clusters():
    units = [SchedulingUnit(gvk="apps/v1/Deployment", namespace="d", name=f"w{i}")
             for i in range(3)]
    clusters = [
        ClusterState(
            name=name, labels={"region": region}, taints=(),
            allocatable=parse_resources({"cpu": "4"}), available=parse_resources({"cpu": "2"}),
            api_resources=frozenset({"apps/v1/Deployment"}),
        )
        for name, region in (("c1", "us"), ("c22", "eu"), ("c333", "eu"))
    ]
    return units, clusters


def client_view(ext_mod, serve_batch: bool) -> dict:
    """What the JAX client reads from one package's service."""
    service = ext_mod.ExtensionService(
        filter_fn=region_filter, score_fn=name_score, select_fn=first_select,
        serve_batch=serve_batch,
    )
    service.start()
    try:
        config = service.webhook_configuration("hook")
        plugin = jax_webhook.WebhookPlugin(jax_webhook.parse_webhook_config(config))
        units, clusters = units_and_clusters()
        return {
            "config": {k: v for k, v in config["spec"].items() if k != "urlPrefix"},
            "filter": [[plugin.filter(su, c) for c in clusters] for su in units],
            "score": [[plugin.score(su, c) for c in clusters] for su in units],
            "filter_batch": plugin.filter_batch(units, clusters),
            "score_batch": plugin.score_batch(units, clusters),
            "select": plugin.select(units[0], [(c, 1) for c in clusters]),
        }
    finally:
        service.stop()


@pytest.mark.parametrize("serve_batch", [True, False], ids=["batch", "per_pair_only"])
def test_jax_client_against_port_service(serve_batch):
    want = client_view(jax_ext, serve_batch)
    got = client_view(port_ext, serve_batch)
    assert got == want
    if serve_batch:
        assert got["filter_batch"] == [[False, True, True]] * 3
    else:
        assert got["filter_batch"] is None
