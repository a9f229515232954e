"""kwok-lite: a multi-cluster farm of real HTTP apiservers.

A copy of ``kubeadmiral_tpu/testing/kwoklite.py`` for the port's control
plane.

Plays the role kwokctl plays in the reference's e2e suite (reference:
test/e2e/framework/clusterprovider/kwokprovider.go:70-260): provisions a
host apiserver plus N member apiservers — real sockets, auth, watches —
without real kubelets.  Member servers mint service-account tokens (the
piece of the cluster-join handshake a bare store can't provide), and
each member gets a bootstrap join secret on the host carrying its admin
token, mirroring how a kubeadmiral operator seeds cluster credentials
before the join handshake upgrades them to a service-account token.
"""

from __future__ import annotations

import json
import secrets as pysecrets
import subprocess
import sys

from kubeadmiral_tpu_torch.testing.fakekube import FakeKube
from kubeadmiral_tpu_torch.transport.apiserver import KubeApiServer
from kubeadmiral_tpu_torch.transport.client import (
    FED_SYSTEM_NAMESPACE,
    SECRETS,
    HttpFleet,
    HttpKube,
)
from kubeadmiral_tpu_torch.transport.faults import FaultInjector, FaultPolicy


class KwokLiteFarm:
    """Host + member apiservers on localhost ports.

    ``fleet`` exposes the ClusterFleet interface (host client + join-
    secret-derived member clients) so controllers run over it unmodified.

    ``member_subprocess=True`` runs each member apiserver as its OWN
    PROCESS (``python -m kubeadmiral_tpu_torch.testing.kwokserver``, its
    name and admin token on the command line),
    the reference's kwokctl model (kwokprovider.go:70-260): member-side
    request handling stops sharing the controllers' GIL, so HTTP
    numbers measure the control plane, not single-interpreter
    serialization.
    """

    def __init__(
        self,
        host_token: str | None = None,
        host_port: int = 0,
        member_subprocess: bool | None = None,
    ):
        self.host_store = FakeKube("host")
        # Fault-injection seam: per-member FaultPolicy honored by every
        # in-process member apiserver (set_fault/clear_fault below) —
        # how `make chaos` partitions, stalls and flaps members.
        self.faults = FaultInjector()
        self.host_server = KubeApiServer(
            self.host_store, admin_token=host_token, port=host_port
        )
        self.host = HttpKube(self.host_server.url, token=host_token, name="host")
        self.fleet = HttpFleet(self.host)
        self.member_servers: dict[str, KubeApiServer] = {}
        self.member_procs: dict[str, subprocess.Popen] = {}
        self._member_tokens: dict[str, str] = {}
        self._member_stderr: dict[str, object] = {}
        self._member_urls: dict[str, str] = {}
        self._extra_clients: list[HttpKube] = []
        # name -> admin client, for the fault-control endpoint.
        self._member_clients: dict[str, HttpKube] = {}
        # Explicit opt-in only: consumers that reach into member_servers
        # (tests, the __main__ demo) default-construct the farm.
        self.member_subprocess = bool(member_subprocess)

    def endpoint(self, name: str) -> str:
        return self._member_urls[name]

    # -- fault injection --------------------------------------------------
    def set_fault(self, name: str, policy: FaultPolicy) -> None:
        """Apply a FaultPolicy to one member apiserver.  In-process
        members share this farm's injector directly; subprocess members
        are driven over the wire through the member's fault-control
        endpoint (POST /faultz — exempt from the fault gate, so a
        partition can always be cleared)."""
        if name in self.member_procs:
            self._fault_request(name, policy)
            return
        self.faults.set_fault(name, policy)

    def clear_fault(self, name: str) -> None:
        if name in self.member_procs:
            self._fault_request(name, None)
            return
        self.faults.clear(name)

    def _fault_request(self, name: str, policy: FaultPolicy | None) -> None:
        import dataclasses

        client = self._member_clients[name]
        body = {
            "policy": dataclasses.asdict(policy) if policy is not None else None
        }
        status, payload, _ = client._request("POST", "/faultz", body)
        if status != 200:
            raise RuntimeError(
                f"fault control on {name} failed: HTTP {status} {payload}"
            )

    def scrape_roster(self) -> list[tuple[str, str, str | None]]:
        """(instance, url, admin token) for every provisioned member —
        the roster the manager-side fleet scraper
        (runtime/fleetscrape.py) walks for /debug/fleet.  Computed per
        call: membership changes as members join or die."""
        return [
            (name, self._member_urls[name], client._token)
            for name, client in sorted(self._member_clients.items())
        ]

    def cluster_spec(self, name: str) -> dict:
        """The FederatedCluster spec fields pointing at this member."""
        return {
            "apiEndpoint": self.endpoint(name),
            "secretRef": {"name": f"{name}-secret"},
        }

    def spawn_members(self, names) -> None:
        """Launch member subprocesses WITHOUT waiting for them: child
        startup (a full package import each) overlaps instead of
        serializing at seconds-per-member; a later add_member collects
        each child's url."""
        if not self.member_subprocess:
            return
        for name in names:
            if name not in self.member_procs:
                self._launch_member(name)

    def add_member(self, name: str) -> HttpKube:
        """Provision a member apiserver + bootstrap join secret; returns
        an admin client for test setup writes."""
        if self.member_subprocess:
            if name not in self.member_procs:
                self._launch_member(name)
            admin_token = self._member_tokens[name]
            url = self._await_member_url(name)
        else:
            from kubeadmiral_tpu_torch.runtime.metrics import Metrics

            admin_token = f"admin-{name}-{pysecrets.token_hex(8)}"
            store = FakeKube(name)
            # Each member gets its own registry (request counts by
            # verb at GET /metrics) so the fleet scraper sees the same
            # per-instance page whether members are threads or
            # subprocesses.
            server = KubeApiServer(
                store, admin_token=admin_token, mint_sa_tokens=True,
                fault_injector=self.faults, fault_name=name,
                metrics=Metrics(),
            )
            self.member_servers[name] = server
            url = server.url
        self._member_urls[name] = url
        self.host.create(
            SECRETS,
            {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": f"{name}-secret",
                    "namespace": FED_SYSTEM_NAMESPACE,
                },
                "data": {"token": admin_token},
            },
        )
        client = HttpKube(url, token=admin_token, name=name)
        self._extra_clients.append(client)
        self._member_clients[name] = client
        return client

    def _launch_member(self, name: str) -> None:
        import tempfile

        admin_token = f"admin-{name}-{pysecrets.token_hex(8)}"
        # The member's configuration rides the command line; the child
        # inherits this process's environment untouched.
        stderr = tempfile.TemporaryFile()
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeadmiral_tpu_torch.testing.kwokserver",
             "--name", name, "--token", admin_token],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=stderr,
            text=True,
        )
        self.member_procs[name] = proc
        self._member_tokens[name] = admin_token
        self._member_stderr[name] = stderr

    def _await_member_url(self, name: str) -> str:
        proc = self.member_procs[name]
        # Tolerate stray stdout noise from imports: scan for the
        # protocol's JSON line instead of trusting line one.
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)["url"]
                except (ValueError, KeyError):
                    continue
        proc.kill()
        proc.wait()  # reap: a killed child must not linger as a zombie
        stderr = self._member_stderr.get(name)
        tail = b""
        if stderr is not None:
            try:
                stderr.seek(0)
                tail = stderr.read()[-2000:]
            except Exception:
                pass
        raise RuntimeError(
            f"kwokserver {name} died before reporting its url; "
            f"stderr tail: {tail.decode(errors='replace')!r}"
        )

    def close(self) -> None:
        for client in self._extra_clients:
            client.close()
        self.fleet.close()
        for server in self.member_servers.values():
            server.close()
        for proc in self.member_procs.values():
            try:
                proc.stdin.close()  # EOF: the child shuts itself down
            except Exception:
                pass
        for proc in self.member_procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:
                proc.kill()
                proc.wait()  # reap the SIGKILL
        for stderr in self._member_stderr.values():
            try:
                stderr.close()
            except Exception:
                pass
        self.host_server.close()
