"""Self-signed serving certificates for the webhook.

Reference: the external ``open-policy-agent/cert-controller`` module
(go.mod:17, wired at main.go:288-315) generates a CA + serving cert, stores
them in a secret, and injects the CA bundle into webhook configurations.
Here: openssl-based generation of a CA and a SAN'd serving cert; the CA PEM
doubles as the ``caBundle`` for a ValidatingWebhookConfiguration.
"""

from __future__ import annotations

import base64
import os
import subprocess
import tempfile


class CertError(Exception):
    pass


def generate_certs(out_dir: str, service: str = "gatekeeper-webhook-service",
                   namespace: str = "gatekeeper-system",
                   days: int = 3650) -> dict:
    """Returns paths: {ca, cert, key} plus the base64 caBundle."""
    os.makedirs(out_dir, exist_ok=True)
    ca_key = os.path.join(out_dir, "ca.key")
    ca_crt = os.path.join(out_dir, "ca.crt")
    srv_key = os.path.join(out_dir, "tls.key")
    srv_csr = os.path.join(out_dir, "tls.csr")
    srv_crt = os.path.join(out_dir, "tls.crt")
    cn = f"{service}.{namespace}.svc"
    san = (f"subjectAltName=DNS:{service},DNS:{service}.{namespace},"
           f"DNS:{cn},DNS:{cn}.cluster.local,DNS:localhost,IP:127.0.0.1")

    def run(*cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise CertError(f"{' '.join(cmd[:3])}...: {proc.stderr.strip()}")

    run("openssl", "genrsa", "-out", ca_key, "2048")
    run("openssl", "req", "-x509", "-new", "-nodes", "-key", ca_key,
        "-subj", "/CN=gatekeeper-ca", "-days", str(days), "-out", ca_crt)
    run("openssl", "genrsa", "-out", srv_key, "2048")
    run("openssl", "req", "-new", "-key", srv_key, "-subj", f"/CN={cn}",
        "-addext", san, "-out", srv_csr)
    with tempfile.NamedTemporaryFile("w", suffix=".cnf", delete=False) as f:
        f.write(san + "\n")
        ext = f.name
    try:
        run("openssl", "x509", "-req", "-in", srv_csr, "-CA", ca_crt,
            "-CAkey", ca_key, "-CAcreateserial", "-days", str(days),
            "-extfile", ext, "-out", srv_crt)
    finally:
        os.unlink(ext)
    with open(ca_crt, "rb") as f:
        ca_bundle = base64.b64encode(f.read()).decode()
    return {"ca": ca_crt, "cert": srv_crt, "key": srv_key,
            "ca_bundle": ca_bundle}


def webhook_configuration(ca_bundle: str, url: str) -> dict:
    """A ValidatingWebhookConfiguration pointing at this server with the CA
    injected (the cert-controller's CABundle injection equivalent)."""
    return {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": "gatekeeper-validating-webhook-configuration"},
        "webhooks": [{
            "name": "validation.gatekeeper.sh",
            "admissionReviewVersions": ["v1"],
            "sideEffects": "None",
            "failurePolicy": "Ignore",
            "clientConfig": {"url": url, "caBundle": ca_bundle},
            "rules": [{"apiGroups": ["*"], "apiVersions": ["*"],
                       "operations": ["CREATE", "UPDATE", "DELETE"],
                       "resources": ["*"]}],
        }],
    }


WEBHOOK_CONFIG_NAMES = (
    ("ValidatingWebhookConfiguration",
     "gatekeeper-validating-webhook-configuration"),
    ("MutatingWebhookConfiguration",
     "gatekeeper-mutating-webhook-configuration"),
)


def ensure_cluster_certs(cluster, certs_dir: str,
                         namespace: str = "gatekeeper-system",
                         secret_name: str = "gatekeeper-webhook-server-cert",
                         service: str = "gatekeeper-webhook-service",
                         webhook_configs=WEBHOOK_CONFIG_NAMES) -> tuple:
    """Cert bootstrap against a live cluster — the cert-controller
    equivalent (reference module open-policy-agent/cert-controller, wired
    main.go:288-315): consume the serving chain from the cert Secret; if
    it's empty, ONE replica generates and publishes it (last-writer-wins,
    then every replica re-reads, so all replicas converge on the stored
    chain) and injects caBundle into the webhook configurations.

    Returns (certfile, keyfile).  Files are written to ``certs_dir``,
    falling back to a scratch dir when the mount is read-only (Secret
    volumes always are — kubelet propagation isn't needed since the
    chain comes from the API)."""
    import tempfile as _tempfile

    secret_gvk = ("", "v1", "Secret")
    sec = cluster.get(secret_gvk, namespace, secret_name)
    data = (sec or {}).get("data") or {}
    if not data.get("tls.crt"):
        scratch = _tempfile.mkdtemp(prefix="gk-certgen-")
        generate_certs(scratch, service=service, namespace=namespace)

        def b64(p):
            with open(os.path.join(scratch, p), "rb") as f:
                return base64.b64encode(f.read()).decode()

        cluster.apply({
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": secret_name, "namespace": namespace,
                         "labels": {"gatekeeper.sh/system": "yes"}},
            "type": "kubernetes.io/tls",
            "data": {"tls.crt": b64("tls.crt"), "tls.key": b64("tls.key"),
                     "ca.crt": b64("ca.crt")},
        })
        # re-read: a racing replica's write wins deterministically for
        # everyone (all serve the STORED chain, one consistent CA)
        sec = cluster.get(secret_gvk, namespace, secret_name)
        data = (sec or {}).get("data") or {}
    # materialize the stored chain locally for the TLS context
    out_dir = certs_dir
    try:
        os.makedirs(out_dir, exist_ok=True)
        probe = os.path.join(out_dir, ".rw-probe")
        with open(probe, "w"):
            pass
        os.unlink(probe)
    except OSError:
        out_dir = _tempfile.mkdtemp(prefix="gk-certs-")
    for fname in ("tls.crt", "tls.key", "ca.crt"):
        blob = base64.b64decode(data.get(fname, ""))
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(blob)
    inject_ca_bundle(cluster, data.get("ca.crt", ""), webhook_configs)
    return (os.path.join(out_dir, "tls.crt"),
            os.path.join(out_dir, "tls.key"))


def inject_ca_bundle(cluster, ca_bundle: str,
                     webhook_configs=WEBHOOK_CONFIG_NAMES) -> None:
    """Set clientConfig.caBundle on every webhook of the named
    configurations (the cert-controller's CABundle injection)."""
    if not ca_bundle:
        return
    for kind, name in webhook_configs:
        cfg = cluster.get(("admissionregistration.k8s.io", "v1", kind),
                          "", name)
        if cfg is None:
            continue
        changed = False
        for wh in cfg.get("webhooks") or []:
            cc = wh.setdefault("clientConfig", {})
            if cc.get("caBundle") != ca_bundle:
                cc["caBundle"] = ca_bundle
                changed = True
        if changed:
            cluster.apply(cfg)


def cert_expires_within(cert_path: str, seconds: float) -> bool:
    """True if the certificate at ``cert_path`` expires within ``seconds``
    (or can't be read) — drives the rotation loop."""
    import subprocess

    try:
        proc = subprocess.run(
            ["openssl", "x509", "-checkend", str(int(seconds)),
             "-noout", "-in", cert_path],
            capture_output=True, timeout=10,
        )
    except Exception:
        return True
    return proc.returncode != 0


def rotation_loop(certs_dir: str, server, stop_event,
                  check_interval_s: float = 3600.0,
                  renew_before_s: float = 90 * 24 * 3600.0,
                  cluster=None):
    """Background cert rotation (reference: open-policy-agent/cert-controller
    rotator.go wired at main.go:342): regenerate the chain when it nears
    expiry and hot-reload the serving context.  With ``cluster`` (live
    apiserver mode) the renewal republishes the Secret + caBundle so every
    replica converges on the new chain."""
    import os

    crt = os.path.join(certs_dir, "tls.crt")
    while not stop_event.wait(check_interval_s):
        if cert_expires_within(crt, renew_before_s):
            if cluster is not None:
                # wipe + re-bootstrap through the Secret (one replica
                # wins; the others pick the stored chain up on their own
                # next expiry check via ensure_cluster_certs)
                try:
                    cluster.delete({
                        "apiVersion": "v1", "kind": "Secret",
                        "metadata": {
                            "name": "gatekeeper-webhook-server-cert",
                            "namespace": "gatekeeper-system"}})
                except Exception:
                    pass
                ensure_cluster_certs(cluster, certs_dir)
            else:
                generate_certs(certs_dir)
            if server is not None:
                server.reload_certs()
