"""
Modbus/TCP Security — TLS transport with certificate-based roles.

The reference explicitly lists "No authentication or encryption" as a
protocol limitation (reference README.md:536 and modbus/README.md:172-180);
this module closes that gap with the Modbus Organization's own security
spec (MB-TCP-Security-v21, the "mbaps" protocol on port 802):

- **TLS transport** for the Modbus/TCP application protocol — same MBAP
  framing and PDUs (slave.py), inside a TLS 1.2+ session.
- **Mandatory mutual authentication**: both endpoints present X.509
  certificates validated against a configured trust anchor (the spec
  makes client certificates mandatory, unlike plain HTTPS).
- **Role-based authorization**: the client's certificate may carry the
  spec's RoleOID extension (1.3.6.1.4.1.50316.802.1 — an ASN.1 string
  naming the client's role). The server maps roles to permissions
  ("ro" — read-only function codes, "rw" — everything, "deny") and
  answers unauthorized write PDUs with ILLEGAL FUNCTION while counting
  them (``unauthorized_count``, exported with the FC 08 counters).

Scope note: the TLS plane is served by the Python asyncio server
(slave.py); the C++ data plane (native/modbus_server.cpp) stays
plaintext-only, like every fieldbus-side deployment that terminates TLS
at a front proxy. ``generate_test_pki`` builds a throwaway CA +
endpoint certificates for tests, demos, and commissioning — production
deployments bring their own PKI.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass, field
from typing import Dict, Optional

# Modbus Organization's registered OID arc for the security spec; .802.1
# is the client-role extension (MB-TCP-Security-v21 section 4.1.2).
MODBUS_ROLE_OID = "1.3.6.1.4.1.50316.802.1"

# IANA-assigned port for Modbus/TCP Security ("mbaps").
MBAPS_PORT = 802

_VALID_PERMISSIONS = ("deny", "ro", "rw")

# Function codes whose PDUs mutate server state. FC 08 is read-like
# except sub-function 0x0A (Clear Counters); FC 23 writes before it
# reads (spec 6.17), so it needs write permission.
_WRITE_FCS = frozenset((0x05, 0x06, 0x0F, 0x10, 0x16, 0x17))
_DIAG_CLEAR_COUNTERS = 0x000A


@dataclass
class ModbusTLSConfig:
    """TLS plane configuration (spec MB-TCP-Security-v21).

    ``role_permissions`` maps RoleOID strings to "ro"/"rw"/"deny";
    ``default_permission`` applies to authenticated clients whose
    certificate has no role extension or an unmapped role. The spec
    leaves the authorization policy to the server — read-only default
    is the conservative choice for a plant endpoint (a SCADA historian
    works out of the box; actuator writes need an explicit role).
    """

    certfile: str
    keyfile: str
    cafile: str
    role_permissions: Dict[str, str] = field(default_factory=dict)
    default_permission: str = "ro"

    def __post_init__(self):
        for role, perm in self.role_permissions.items():
            if perm not in _VALID_PERMISSIONS:
                raise ValueError(
                    f"role {role!r}: permission must be one of "
                    f"{_VALID_PERMISSIONS}, got {perm!r}")
        if self.default_permission not in _VALID_PERMISSIONS:
            raise ValueError(
                f"default_permission must be one of {_VALID_PERMISSIONS}, "
                f"got {self.default_permission!r}")

    def resolve_permission(self, role: Optional[str]) -> str:
        if role is not None and role in self.role_permissions:
            return self.role_permissions[role]
        return self.default_permission


def make_server_ssl_context(cfg: ModbusTLSConfig) -> ssl.SSLContext:
    """TLS 1.2+ server context with MANDATORY client certificates
    (mutual authentication is not optional in the Modbus security spec)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cfg.certfile, cfg.keyfile)
    ctx.load_verify_locations(cafile=cfg.cafile)
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def make_client_ssl_context(certfile: str, keyfile: str, cafile: str,
                            check_hostname: bool = True) -> ssl.SSLContext:
    """TLS client context presenting a client certificate (the server
    will refuse the handshake without one)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(certfile, keyfile)
    ctx.load_verify_locations(cafile=cafile)
    ctx.check_hostname = check_hostname
    return ctx


def _decode_asn1_string(der: bytes) -> Optional[str]:
    """Decode a single DER-encoded string value (UTF8String 0x0C,
    PrintableString 0x13, or IA5String 0x16) — the RoleOID payload."""
    if len(der) < 2 or der[0] not in (0x0C, 0x13, 0x16):
        return None
    length = der[1]
    offset = 2
    if length & 0x80:                      # multi-byte length
        n = length & 0x7F
        if n == 0 or len(der) < 2 + n:
            return None
        length = int.from_bytes(der[2:2 + n], "big")
        offset = 2 + n
    if len(der) < offset + length:
        return None
    try:
        return der[offset:offset + length].decode("utf-8")
    except UnicodeDecodeError:
        return None


def extract_role(cert_der: Optional[bytes]) -> Optional[str]:
    """Extract the Modbus RoleOID extension value from a DER client
    certificate; None when absent or unparseable."""
    if not cert_der:
        return None
    try:
        from cryptography import x509
    except ImportError:                    # pragma: no cover - baked in
        return None
    try:
        cert = x509.load_der_x509_certificate(cert_der)
        for ext in cert.extensions:
            if ext.oid.dotted_string == MODBUS_ROLE_OID:
                # private OID ⇒ UnrecognizedExtension; .value is raw DER
                der = getattr(ext.value, "value", None)
                if not isinstance(der, bytes):
                    der = ext.value.public_bytes()
                return _decode_asn1_string(der)
    except Exception:  # noqa: BLE001 — malformed cert ⇒ no role
        return None
    return None


def pdu_requires_write(pdu: bytes) -> bool:
    """True when serving this PDU would mutate server state (used by the
    read-only role gate)."""
    if not pdu:
        return False
    fc = pdu[0]
    if fc in _WRITE_FCS:
        return True
    if fc == 0x08 and len(pdu) >= 3:       # FC 08: only Clear Counters
        sub = int.from_bytes(pdu[1:3], "big")
        return sub == _DIAG_CLEAR_COUNTERS
    return False


def generate_test_pki(directory, roles: Dict[str, Optional[str]],
                      valid_days: int = 7) -> Dict[str, Dict[str, str]]:
    """Build a throwaway PKI for tests/demos: one CA, one server
    certificate (SANs: localhost + 127.0.0.1), and one client
    certificate per entry in ``roles`` (name → RoleOID value, or None
    for a certificate without the role extension).

    Returns {"ca": {"cert": path}, "server": {"cert", "key"},
    <client>: {"cert", "key"}}. NOT for production — keys land on disk
    unencrypted and the CA is self-signed with a short lifetime.
    """
    import datetime
    import ipaddress
    import os

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    os.makedirs(directory, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=valid_days)

    def _name(cn):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    def _write(path, data):
        with open(path, "wb") as f:
            f.write(data)
        return path

    def _key_pem(key):
        return key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_cert = (x509.CertificateBuilder()
               .subject_name(_name("wt-sim test CA"))
               .issuer_name(_name("wt-sim test CA"))
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now).not_valid_after(not_after)
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    out = {"ca": {"cert": _write(os.path.join(directory, "ca.pem"),
                                 ca_cert.public_bytes(
                                     serialization.Encoding.PEM))}}

    def _issue(cn, extra_exts=()):
        key = ec.generate_private_key(ec.SECP256R1())
        builder = (x509.CertificateBuilder()
                   .subject_name(_name(cn))
                   .issuer_name(ca_cert.subject)
                   .public_key(key.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now).not_valid_after(not_after))
        for critical, ext in extra_exts:
            builder = builder.add_extension(ext, critical=critical)
        return key, builder.sign(ca_key, hashes.SHA256())

    server_key, server_cert = _issue("wt-sim server", extra_exts=(
        (False, x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1"))])),))
    out["server"] = {
        "cert": _write(os.path.join(directory, "server.pem"),
                       server_cert.public_bytes(
                           serialization.Encoding.PEM)),
        "key": _write(os.path.join(directory, "server.key"),
                      _key_pem(server_key)),
    }

    for client, role in roles.items():
        exts = []
        if role is not None:
            # DER UTF8String payload for the RoleOID extension
            role_der = bytes([0x0C, len(role.encode())]) + role.encode()
            exts.append((False, x509.UnrecognizedExtension(
                x509.ObjectIdentifier(MODBUS_ROLE_OID), role_der)))
        key, cert = _issue(f"wt-sim client {client}", extra_exts=exts)
        out[client] = {
            "cert": _write(os.path.join(directory, f"{client}.pem"),
                           cert.public_bytes(serialization.Encoding.PEM)),
            "key": _write(os.path.join(directory, f"{client}.key"),
                          _key_pem(key)),
        }
    return out
