"""TLS plumbing (ref: client/pkg/transport/listener.go TLSInfo,
tlsutil/ — cipher/cert helpers; listener.go:79 NewTLSListener,
listener.go:283 SelfCert).

``TLSInfo`` carries file paths + policy and builds ``ssl.SSLContext``s
for both directions; ``self_cert`` generates a self-signed CA + server
cert on disk (the --auto-tls path). Generation prefers the
``cryptography`` package and falls back to the ``openssl`` CLI, gated
so neither is a hard dependency.

Ports ``etcd_tpu/pkg/tlsutil.py``.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TLSInfo:
    """ref: transport/listener.go:146-170 TLSInfo fields."""

    cert_file: str = ""
    key_file: str = ""
    trusted_ca_file: str = ""
    client_cert_auth: bool = False
    insecure_skip_verify: bool = False
    server_name: str = ""
    # client cert presented when dialing (peer transport uses the same
    # cert both ways, listener.go ClientCertFile defaults to CertFile)
    client_cert_file: str = ""
    client_key_file: str = ""

    def empty(self) -> bool:
        return not (self.cert_file or self.key_file)

    def server_context(self) -> ssl.SSLContext:
        """ref: listener.go:340 ServerConfig."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.trusted_ca_file:
            ctx.load_verify_locations(self.trusted_ca_file)
        if self.client_cert_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """ref: listener.go:376 ClientConfig."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        if self.trusted_ca_file:
            ctx.load_verify_locations(self.trusted_ca_file)
        else:
            ctx.load_default_certs()
        if self.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        cert = self.client_cert_file or self.cert_file
        key = self.client_key_file or self.key_file
        if cert and key:
            ctx.load_cert_chain(cert, key)
        return ctx


def self_cert(dirpath: str, hosts: Optional[List[str]] = None,
              skip_verify: bool = True) -> TLSInfo:
    """Generate a self-signed cert+key under ``dirpath`` and return a
    TLSInfo for it (ref: listener.go:283 SelfCert — the --auto-tls /
    --peer-auto-tls path).

    ``skip_verify`` defaults True to match the reference: every member
    of a self-cert cluster generates its *own* cert, so peers cannot
    verify each other against any shared CA — SelfCert marks the info
    and ClientConfig sets InsecureSkipVerify (listener.go selfCert
    handling). The channel is encrypted but not authenticated. Pass
    ``skip_verify=False`` only when every party shares this one cert
    directory (e.g. test fixtures doing strict verification)."""
    hosts = hosts or ["127.0.0.1", "localhost"]
    os.makedirs(dirpath, exist_ok=True)
    cert_path = os.path.join(dirpath, "cert.pem")
    key_path = os.path.join(dirpath, "key.pem")
    if not (os.path.exists(cert_path) and os.path.exists(key_path)):
        try:
            _self_cert_cryptography(cert_path, key_path, hosts)
        except ImportError:
            _self_cert_openssl(cert_path, key_path, hosts)
    return TLSInfo(
        cert_file=cert_path,
        key_file=key_path,
        trusted_ca_file=cert_path,
        insecure_skip_verify=skip_verify,
    )


def _self_cert_cryptography(cert_path: str, key_path: str,
                            hosts: List[str]) -> None:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.ORGANIZATION_NAME, "etcd-tpu")])
    sans: List[x509.GeneralName] = []
    for h in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    os.chmod(key_path, 0o600)


def _self_cert_openssl(cert_path: str, key_path: str,
                       hosts: List[str]) -> None:
    sans = []
    for h in hosts:
        try:
            ipaddress.ip_address(h)
            sans.append(f"IP:{h}")
        except ValueError:
            sans.append(f"DNS:{h}")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec",
         "-pkeyopt", "ec_paramgen_curve:prime256v1",
         "-keyout", key_path, "-out", cert_path,
         "-days", "365", "-nodes", "-subj", "/O=etcd-tpu",
         "-addext", "subjectAltName=" + ",".join(sans)],
        check=True, capture_output=True)
    os.chmod(key_path, 0o600)
