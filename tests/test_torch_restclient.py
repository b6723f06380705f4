"""The port's REST client (kube/restclient.py): kubeconfig / in-cluster
config loading (reference cmd/clients.go:30-76) and the Status→error
mapping — the reference package's cases, plus each held equal to the
JAX package's client on the same input."""

import base64
import json

import pytest

from k8s_spark_scheduler_tpu_torch.kube.errors import (
    AlreadyExistsError,
    ConflictError,
    NamespaceTerminatingError,
    NotFoundError,
)
from k8s_spark_scheduler_tpu_torch.kube.restclient import (
    _error_from_status,
    in_cluster_config,
    load_kubeconfig,
)

FAKE_PEM = b"-----BEGIN CERTIFICATE-----\nZmFrZQ==\n-----END CERTIFICATE-----\n"


def _kubeconfig_dict():
    return {
        "apiVersion": "v1",
        "kind": "Config",
        "current-context": "dev",
        "contexts": [
            {"name": "dev", "context": {"cluster": "dev-cluster", "user": "dev-user"}},
            {"name": "other", "context": {"cluster": "x", "user": "y"}},
        ],
        "clusters": [
            {
                "name": "dev-cluster",
                "cluster": {
                    "server": "https://10.1.2.3:6443",
                    "certificate-authority-data": base64.b64encode(FAKE_PEM).decode(),
                },
            },
            {"name": "x", "cluster": {"server": "https://other:6443"}},
        ],
        "users": [
            {"name": "dev-user", "user": {"token": "sekret-token"}},
            {"name": "y", "user": {}},
        ],
    }


def test_load_kubeconfig_json(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_kubeconfig_dict()))
    cfg = load_kubeconfig(str(path))
    assert cfg.host == "https://10.1.2.3:6443"
    assert cfg.bearer_token == "sekret-token"
    assert cfg.ca_file and open(cfg.ca_file, "rb").read() == FAKE_PEM


def test_load_kubeconfig_context_override(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_kubeconfig_dict()))
    cfg = load_kubeconfig(str(path), context="other")
    assert cfg.host == "https://other:6443"
    assert cfg.bearer_token is None


def test_load_kubeconfig_unknown_context(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_kubeconfig_dict()))
    with pytest.raises(RuntimeError, match="context"):
        load_kubeconfig(str(path), context="nope")


def test_in_cluster_config(tmp_path, monkeypatch):
    sa = tmp_path / "serviceaccount"
    sa.mkdir()
    (sa / "token").write_text("sa-token\n")
    (sa / "ca.crt").write_bytes(FAKE_PEM)
    monkeypatch.setattr(
        "k8s_spark_scheduler_tpu_torch.kube.restclient.SERVICE_ACCOUNT_DIR", str(sa)
    )
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.9.8.7")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    cfg = in_cluster_config()
    assert cfg.host == "https://10.9.8.7:6443"
    # the token must be file-referenced, not snapshotted: bound SA
    # tokens rotate and a static copy would 401 after expiry
    assert cfg.bearer_token_file == str(sa / "token")
    assert cfg.ca_file == str(sa / "ca.crt")


def test_bearer_token_reloads_from_file(tmp_path):
    from k8s_spark_scheduler_tpu_torch.kube.restclient import ClusterConfig, RestClient

    token_file = tmp_path / "token"
    token_file.write_text("token-v1")
    client = RestClient(
        ClusterConfig(host="http://127.0.0.1:1", bearer_token_file=str(token_file))
    )
    assert client._headers()["Authorization"] == "Bearer token-v1"
    token_file.write_text("token-v2")
    client._token_read_at = -1e9  # force the refresh window open
    assert client._headers()["Authorization"] == "Bearer token-v2"


def test_in_cluster_requires_env(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="in-cluster"):
        in_cluster_config()


@pytest.mark.parametrize(
    "code,reason,message,expected",
    [
        (404, "NotFound", "pods \"p\" not found", NotFoundError),
        (409, "AlreadyExists", "already exists", AlreadyExistsError),
        (409, "Conflict", "the object has been modified", ConflictError),
        (
            403,
            "Forbidden",
            "unable to create new content in namespace doomed because it is being terminated",
            NamespaceTerminatingError,
        ),
    ],
)
def test_error_taxonomy(code, reason, message, expected):
    body = json.dumps(
        {"kind": "Status", "reason": reason, "message": message, "code": code}
    ).encode()
    assert isinstance(_error_from_status(code, body), expected)


def test_kubeconfig_and_taxonomy_equal_the_reference(tmp_path):
    from k8s_spark_scheduler_tpu.kube import restclient as jax_restclient

    path = tmp_path / "config.json"
    path.write_text(json.dumps(_kubeconfig_dict()))
    for context in (None, "other"):
        ours = load_kubeconfig(str(path), context=context, qps=5, burst=3)
        theirs = jax_restclient.load_kubeconfig(str(path), context=context, qps=5, burst=3)
        for name in ("host", "client_cert_file", "client_key_file", "bearer_token",
                     "bearer_token_file", "insecure_skip_verify", "qps", "burst"):
            assert getattr(ours, name) == getattr(theirs, name), name
        assert (ours.ca_file is None) == (theirs.ca_file is None)
        if ours.ca_file:
            assert open(ours.ca_file, "rb").read() == open(theirs.ca_file, "rb").read()
    for code, reason, message in [
        (404, "NotFound", "x"), (409, "AlreadyExists", "x"), (409, "Conflict", "x"),
        (403, "Forbidden", "denied"), (403, "NamespaceTerminating", "ns"),
        (500, "InternalError", "boom"), (422, "Invalid", ""),
    ]:
        body = json.dumps({"kind": "Status", "reason": reason, "message": message,
                           "code": code, "details": {"name": "doomed"}}).encode()
        ours, theirs = _error_from_status(code, body), jax_restclient._error_from_status(code, body)
        assert (type(ours).__name__, str(ours), getattr(ours, "code", None)) == (
            type(theirs).__name__, str(theirs), getattr(theirs, "code", None))
