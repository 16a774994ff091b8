"""The apiserver surface of the port's node agent: the client interface,
an in-memory fake and the raw-REST client (the JAX package's ``k8s/``)."""

from .client import KubeClient
from .fake import FakeKube
from .rest import RestKube, load_incluster


def make_client(fake: bool = False, kube_url: str = "") -> KubeClient:
    """Shared entrypoint wiring: in-memory fake, explicit URL (apisim or
    off-cluster apiserver), or in-cluster service account."""
    if fake:
        return FakeKube()
    if kube_url:
        return RestKube(base_url=kube_url)
    return load_incluster()


__all__ = ["KubeClient", "FakeKube", "RestKube", "load_incluster", "make_client"]
