"""The port's TLS policy (foundationdb_tpu_torch/real/tls.py) against the
JAX package's: the subject DSL and check_peer decide alike; credentials
made by the port with the openssl binary (the reference uses the
cryptography package, which the port does not import) complete a mutual
handshake, a peer of a wrong CA is refused both ways, the JAX package's
contexts accept the port's credentials, and the 4-process port cluster
runs over mutual TLS."""
import asyncio
import os
import ssl
import subprocess
import sys

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CERTS = [
    {"subject": ((("organizationName", "TestCluster"),), (("commonName", "fdb-tpu-node"),))},
    {"subject": ((("organizationalUnitName", "Ops"),), (("organizationalUnitName", "Storage"),))},
    {"subject": ((("organizationName", "Acme, Inc."),),)},
    {"subject": ((("countryName", "US"),), (("commonName", "x"),))},
    None,
]
RULES = ["", "Check.Valid=1", "O=TestCluster,CN=fdb-tpu-node", "O=Other", "OU=Anything",
         "OU=Ops", "OU=Storage", "OU=Neither", r"Check.Valid=1,O=Acme\, Inc.",
         r"O=Acme\, Inc.", "Bogus=1", "C=US", "C=US,CN=x", "Check.Valid=0", "CN=",
         "O=TestCluster,,CN=fdb-tpu-node", r"O=a\\b"]


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    for P in BOTH:
        P.tls.set_tls(None)
    yield
    for P in BOTH:
        P.tls.set_tls(None)
    clean_world()


def _decide(P, cert, rule):
    try:
        return P.tls.check_peer(cert, rule)
    except Exception as e:  # noqa: BLE001 — the error type is the decision
        return type(e).__name__


@pytest.mark.parametrize("cert", range(len(CERTS)))
def test_subject_dsl_decisions_equal_jax(cert):
    port = [_decide(PORT, CERTS[cert], r) for r in RULES]
    assert port == [_decide(JAX, CERTS[cert], r) for r in RULES]


def test_subject_dsl_meets_reference_assertions():
    check = PORT.tls.check_peer
    cert, multi, comma = CERTS[0], CERTS[1], CERTS[2]
    assert check(cert, "") and check(cert, "Check.Valid=1")
    assert check(cert, "O=TestCluster,CN=fdb-tpu-node")
    assert not check(cert, "O=Other") and not check(cert, "OU=Anything")
    assert check(multi, "OU=Ops") and check(multi, "OU=Storage")
    assert not check(multi, "OU=Neither")
    assert check(comma, r"Check.Valid=1,O=Acme\, Inc.")
    assert not check(cert, r"O=Acme\, Inc.") and not check(cert, "Bogus=1")
    assert not check(None, "Check.Valid=1") and check(None, "")


def _subject(path):
    return subprocess.run(["openssl", "x509", "-in", path, "-noout", "-subject", "-issuer"],
                          capture_output=True, text=True, check=True).stdout


def test_openssl_credentials(tmp_path):
    cfg = PORT.tls.generate_test_credentials(str(tmp_path / "a"), org="TestCluster")
    assert cfg.verify_rules == "Check.Valid=1,O=TestCluster"
    text = _subject(cfg.cert_path)
    assert "CN = fdb-tpu-node" in text and "O = TestCluster" in text
    assert "issuer=CN = fdb-tpu-ca" in text
    assert oct(os.stat(cfg.key_path).st_mode & 0o777) == "0o600"
    # the JAX package's contexts load the port's files too
    for P in BOTH:
        cfg_p = P.tls.TLSConfig(cfg.cert_path, cfg.key_path, cfg.ca_path, cfg.verify_rules)
        P.tls._base_context(cfg_p, server=True)
        P.tls._base_context(cfg_p, server=False)


def test_credentials_raise_without_openssl(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="openssl"):
        PORT.tls.generate_test_credentials(str(tmp_path / "x"))


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_wrong_ca_is_refused(tmp_path, client_pkg):
    """A peer presenting a certificate from a different CA fails the
    handshake; the same CA connects, whichever package's client it is."""
    C = PORT if client_pkg == "port" else JAX
    a = PORT.tls.generate_test_credentials(str(tmp_path / "A"))
    b = PORT.tls.generate_test_credentials(str(tmp_path / "B"), org="Imposter")

    async def go():
        PORT.tls.set_tls(a)
        server = await asyncio.start_server(lambda r, w: w.close(), "127.0.0.1", 0,
                                            ssl=PORT.tls.server_context())
        port = server.sockets[0].getsockname()[1]
        try:
            C.tls.set_tls(C.tls.TLSConfig(b.cert_path, b.key_path, b.ca_path, b.verify_rules))
            with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                _r, w = await asyncio.wait_for(asyncio.open_connection(
                    "127.0.0.1", port, ssl=C.tls.client_context()), 10)
                await asyncio.wait_for(_r.read(1), 10)
            C.tls.set_tls(C.tls.TLSConfig(a.cert_path, a.key_path, a.ca_path, a.verify_rules))
            _r, w = await asyncio.wait_for(asyncio.open_connection(
                "127.0.0.1", port, ssl=C.tls.client_context()), 10)
            w.close()
        finally:
            server.close()
            await server.wait_closed()
        return True

    assert asyncio.run(go())


@pytest.mark.timeout(240)
def test_real_cluster_over_tls():
    """The 4-process port cluster with mutual TLS on every connection
    (coordination, recruitment, commits, reads) passes the Cycle ring
    check, on the oracle engine."""
    r = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.real.cluster", "--procs", "4",
         "--keys", "12", "--txns", "15", "--tls", "--engine", "oracle"],
        capture_output=True, text=True, timeout=220, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert "REAL CLUSTER OK" in r.stdout
