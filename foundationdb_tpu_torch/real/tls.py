"""TLS for the real transport: mutual auth + a subject-check DSL.

Port of ``foundationdb_tpu/real/tls.py``.

Re-design of FDBLibTLS (FDBLibTLS/*.cpp, ~2.6k LoC over libtls): every
connection is MUTUALLY authenticated against a shared CA, and an
optional verification DSL constrains the peer certificate's subject
(the reference's `Check.Valid=1,O=...` strings,
FDBLibTLS/FDBLibTLSVerify.cpp). Python's ssl module supplies the
handshake; this module supplies context construction, the DSL, and
self-signed test credentials. The port makes those with the `openssl`
binary (the reference uses the `cryptography` package, which the port
does not import); without the binary the helper raises.

Process-wide configuration (`set_tls`) mirrors the reference's plugin
model: fdbserver loads one TLS policy per process, not per connection.
"""
from __future__ import annotations

import os
import ssl
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class TLSConfig:
    cert_path: str           # this process's PEM cert chain
    key_path: str            # its private key
    ca_path: str             # the CA bundle peers must chain to
    verify_rules: str = ""   # e.g. "Check.Valid=1,O=TestCluster"


def _base_context(cfg: TLSConfig, server: bool) -> ssl.SSLContext:
    ctx = ssl.SSLContext(
        ssl.PROTOCOL_TLS_SERVER if server else ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cfg.cert_path, cfg.key_path)
    ctx.load_verify_locations(cfg.ca_path)
    # identity comes from the CA plus the subject DSL, not hostnames
    # (cluster members are addressed by ip:port) — FDB's model
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED   # MUTUAL: both sides present
    return ctx


class ActiveTLS:
    """An immutable snapshot of the process TLS policy: the config plus
    BOTH contexts built once (PEMs parsed at set_tls time, not per
    connection). Callers grab one snapshot and use it for a whole
    connection, so a concurrent set_tls() can't desync the context a
    socket was opened with from the rules its peer is checked against."""

    def __init__(self, cfg: TLSConfig):
        self.cfg = cfg
        self.client_ctx = _base_context(cfg, server=False)
        self.server_ctx = _base_context(cfg, server=True)


_active: Optional[ActiveTLS] = None


def set_tls(cfg: Optional[TLSConfig]) -> None:
    global _active
    _active = ActiveTLS(cfg) if cfg is not None else None


def current() -> Optional[ActiveTLS]:
    return _active


def client_context() -> Optional[ssl.SSLContext]:
    return _active.client_ctx if _active is not None else None


def server_context() -> Optional[ssl.SSLContext]:
    return _active.server_ctx if _active is not None else None


_SUBJECT_KEYS = {
    "O": "organizationName",
    "OU": "organizationalUnitName",
    "CN": "commonName",
    "C": "countryName",
}


def check_peer(peercert: Optional[dict], rules: str = "") -> bool:
    """Apply the verification DSL to a peer cert as returned by
    `SSLObject.getpeercert()`. Rules: comma-separated `Field=value`
    pairs; `Check.Valid=1` asserts a cert is present (chain validity is
    already enforced by the handshake), `O=`/`OU=`/`CN=`/`C=` match the
    subject. Empty rules accept any CA-validated peer."""
    if not rules:
        return True
    import re

    # multi-valued attributes (two OU= RDNs) collect into sets: a rule
    # matches if ANY value matches, like the reference's verifier
    subject: Dict[str, set] = {}
    for rdn in (peercert or {}).get("subject", ()):
        for key, value in rdn:
            subject.setdefault(key, set()).add(value)
    # backslash-escaped commas let a subject value contain one
    # ("O=Acme\, Inc."), matching FDBLibTLSVerify's escape syntax
    for clause in re.split(r"(?<!\\),", rules):
        clause = clause.replace("\\,", ",").strip()
        if not clause:
            continue
        field, _, want = clause.partition("=")
        field = field.strip()
        want = want.strip()
        if field == "Check.Valid":
            if want not in ("0", "1"):
                return False   # malformed security input: fail closed
            if want == "1" and not peercert:
                return False
        elif field in _SUBJECT_KEYS:
            if want not in subject.get(_SUBJECT_KEYS[field], ()):
                return False
        else:
            return False   # unknown clause: fail closed
    return True


def verify_peer(writer, snap: ActiveTLS) -> bool:
    """Apply `snap`'s subject DSL to the peer behind an established TLS
    stream — the ONE verification sequence both directions of the mutual
    check share, so the client- and server-side policies can't drift."""
    ssl_obj = writer.get_extra_info("ssl_object")
    return ssl_obj is not None and check_peer(ssl_obj.getpeercert(),
                                              snap.cfg.verify_rules)


def _openssl() -> str:
    import shutil

    found = shutil.which("openssl")
    if found is None:
        raise RuntimeError(
            "generate_test_credentials needs the openssl binary on PATH")
    return found


def generate_test_credentials(out_dir: str,
                              org: str = "TestCluster") -> TLSConfig:
    """Self-signed CA + one leaf cert (subject O=`org`) shared by every
    process — enough for mutual-auth tests and dev clusters. PEM files
    land under `out_dir`. Made by the `openssl` binary: RSA 2048 keys,
    SHA-256 signatures, the CA's BasicConstraints CA:TRUE (critical), the
    reference's names (CN=fdb-tpu-ca; CN=fdb-tpu-node, O=`org`), valid
    for 100 years."""
    import subprocess

    openssl = _openssl()
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, name)
             for name in ("ca.pem", "ca.key", "cert.pem", "key.pem", "leaf.csr",
                          "ca.ext")}
    days = "36500"

    def run(*args: str) -> None:
        r = subprocess.run([openssl, *args], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"openssl {args[0]} failed: {r.stderr.strip()}")

    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-sha256",
        "-keyout", paths["ca.key"], "-out", paths["ca.pem"], "-days", days,
        "-subj", "/CN=fdb-tpu-ca",
        "-addext", "basicConstraints=critical,CA:TRUE")
    run("req", "-new", "-newkey", "rsa:2048", "-nodes", "-sha256",
        "-keyout", paths["key.pem"], "-out", paths["leaf.csr"],
        "-subj", f"/CN=fdb-tpu-node/O={org}")
    with open(paths["ca.ext"], "w") as f:
        f.write("basicConstraints=CA:FALSE\n")
    run("x509", "-req", "-in", paths["leaf.csr"], "-CA", paths["ca.pem"],
        "-CAkey", paths["ca.key"], "-CAcreateserial", "-sha256",
        "-days", days, "-extfile", paths["ca.ext"], "-out", paths["cert.pem"])
    for name in ("leaf.csr", "ca.ext"):
        os.remove(paths[name])
    os.chmod(paths["key.pem"], 0o600)   # the one shared private key
    os.chmod(paths["ca.key"], 0o600)
    return TLSConfig(cert_path=paths["cert.pem"], key_path=paths["key.pem"],
                     ca_path=paths["ca.pem"],
                     verify_rules=f"Check.Valid=1,O={org}")
