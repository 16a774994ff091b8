"""Raw-REST Kubernetes client (in-cluster; the port's copy of the JAX
package's ``k8s/rest.py``, on the stdlib's ``urllib``).

The reference uses client-go with in-cluster → kubeconfig fallback
(pkg/k8sutil/client.go:42).  This rebuild carries no vendored client library;
the consumed API surface is small enough that plain HTTPS against the
apiserver is the sturdier choice for an offline-built image.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from .client import Conflict, Gone, KubeClient, NotFound

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def load_incluster() -> "RestKube":
    host = os.environ["KUBERNETES_SERVICE_HOST"]
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    return RestKube(
        base_url=f"https://{host}:{port}",
        # Bound SA tokens rotate on disk (~hourly since k8s 1.21); pass the
        # path so each request re-reads the current token like client-go does.
        token_file=os.path.join(SA_DIR, "token"),
        ca_file=os.path.join(SA_DIR, "ca.crt"),
    )


class RestKube(KubeClient):
    def __init__(self, base_url: str, token: str = "", ca_file: Optional[str] = None,
                 insecure: bool = False, token_file: Optional[str] = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.token_file = token_file
        self._token_cache = ("", 0.0)  # (token, mtime)
        self._token_warned = False
        if insecure:
            self._ctx = ssl._create_unverified_context()
        elif ca_file:
            self._ctx = ssl.create_default_context(cafile=ca_file)
        else:
            self._ctx = ssl.create_default_context()

    def _current_token(self) -> str:
        if not self.token_file:
            return self.token
        try:
            mtime = os.path.getmtime(self.token_file)
            if mtime != self._token_cache[1]:
                with open(self.token_file) as f:
                    self._token_cache = (f.read().strip(), mtime)
        except OSError as e:
            if not self._token_warned:
                log.error("cannot read token file %s: %s", self.token_file, e)
                self._token_warned = True
        return self._token_cache[0] or self.token

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json") -> dict:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        token = self._current_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, context=self._ctx, timeout=30) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise NotFound(path) from e
            if e.code == 409:
                raise Conflict(path) from e
            raise
        return json.loads(payload) if payload else {}

    # -- pods -----------------------------------------------------------------
    def list_pods(self, namespace: Optional[str] = None,
                  node_name: Optional[str] = None) -> List[dict]:
        path = (
            f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"
        )
        if node_name is not None:
            # '' is refused, not passed through: a real apiserver would
            # interpret spec.nodeName= as "all UNSCHEDULED pods" — the
            # opposite of a node scope — while the fakes would match
            # nothing.  A node agent with an empty node-name env is
            # misconfigured; fail it loudly and identically everywhere.
            if not node_name:
                raise ValueError("node_name must be non-empty")
            path += "?fieldSelector=" + urllib.parse.quote(
                f"spec.nodeName={node_name}")
        return self._request("GET", path).get("items", [])

    def list_pods_with_rv(self) -> "tuple[List[dict], str]":
        body = self._request("GET", "/api/v1/pods")
        return (body.get("items", []),
                body.get("metadata", {}).get("resourceVersion", "0"))

    def watch_pods_events(self, resource_version: str,
                          timeout_seconds: float = 50.0):
        """Streamed ``?watch=true`` (reference informer ListWatch,
        scheduler.go:66–86): yields (event, pod, rv) lines until the server
        closes the window.  Raises :class:`Gone` on 410 (re-list needed)."""
        url = (f"{self.base_url}/api/v1/pods?watch=true"
               f"&resourceVersion={resource_version}"
               f"&timeoutSeconds={int(timeout_seconds)}")
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        token = self._current_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            resp = urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout_seconds + 15)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise Gone(f"watch rv {resource_version} expired") from e
            raise
        with resp:
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                evt = json.loads(line)
                obj = evt.get("object", {})
                if evt.get("type") == "ERROR":
                    # A real apiserver signals mid-stream rv expiry as a
                    # 200-stream WatchEvent carrying a Status with code 410
                    # (the HTTP 410 happens only at watch START).  Treating
                    # it as a pod event would silently skip the compaction
                    # gap's DELETEs.
                    if obj.get("code") == 410 or \
                            obj.get("reason") == "Expired":
                        raise Gone(f"watch expired mid-stream: "
                                   f"{obj.get('message', '')}")
                    raise RuntimeError(
                        f"watch ERROR event: {obj.get('message', obj)}")
                yield (evt.get("type", ""), obj,
                       obj.get("metadata", {}).get("resourceVersion", "0"))

    def get_pod(self, namespace: str, name: str) -> dict:
        return self._request("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def patch_pod_annotations(
        self, namespace: str, name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        meta: dict = {"annotations": annotations}
        if resource_version is not None:
            # Same CAS convention as patch_node_annotations: the
            # apiserver enforces optimistic concurrency (409 on
            # mismatch) when the merge patch carries a resourceVersion.
            meta["resourceVersion"] = resource_version
        return self._request(
            "PATCH",
            f"/api/v1/namespaces/{namespace}/pods/{name}",
            {"metadata": meta},
            content_type="application/merge-patch+json",
        )

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            {
                "apiVersion": "v1",
                "kind": "Binding",
                "metadata": {"name": name, "namespace": namespace},
                "target": {"apiVersion": "v1", "kind": "Node", "name": node},
            },
        )

    def create_event(self, namespace: str, involved: dict, reason: str,
                     message: str, type_: str = "Normal") -> None:
        import time as _time

        # core/v1 Events (not events.k8s.io): the minimal shape every
        # kubectl version aggregates under `describe`.  Name must be
        # unique per event; the involved uid + monotonic-ish suffix is
        # the convention client-go's correlator also produces.
        now = _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime())
        name = f"{involved.get('name', 'obj')}.{int(_time.time() * 1e6):x}"
        self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/events",
            {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {"name": name, "namespace": namespace},
                "involvedObject": {
                    "apiVersion": "v1",
                    "kind": involved.get("kind", "Pod"),
                    "name": involved.get("name", ""),
                    "namespace": involved.get("namespace", namespace),
                    "uid": involved.get("uid", ""),
                },
                "reason": reason,
                "message": message,
                "type": type_,
                "source": {"component": "vtpu-scheduler"},
                "firstTimestamp": now,
                "lastTimestamp": now,
                "count": 1,
            },
        )

    # -- nodes ----------------------------------------------------------------
    def list_nodes(self) -> List[dict]:
        return self._request("GET", "/api/v1/nodes").get("items", [])

    def create_node(self, node: dict) -> dict:
        body = dict(node)
        body.setdefault("apiVersion", "v1")
        body.setdefault("kind", "Node")
        return self._request("POST", "/api/v1/nodes", body)

    def get_node(self, name: str) -> dict:
        return self._request("GET", f"/api/v1/nodes/{name}")

    def patch_node_annotations(
        self,
        name: str,
        annotations: Dict[str, Optional[str]],
        resource_version: Optional[str] = None,
    ) -> dict:
        meta: dict = {"annotations": annotations}
        if resource_version is not None:
            # Including resourceVersion in a merge patch makes the apiserver
            # enforce optimistic concurrency (409 on mismatch).
            meta["resourceVersion"] = resource_version
        return self._request(
            "PATCH",
            f"/api/v1/nodes/{name}",
            {"metadata": meta},
            content_type="application/merge-patch+json",
        )
