"""PAP / CHAP-MD5 authentication for PPPoE sessions.

The port's copy of `bng_tpu/control/pppoe/auth.py` (jax-free).

Parity: pkg/pppoe/auth.go — Authenticator with PAP (:202-298), CHAP MD5
(:323-493), per-MAC rate limiting (:542-564) and password zeroing (:580).
Verification is pluggable: a local secret source or a RADIUS client.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from dataclasses import dataclass, field
from typing import Callable, Protocol

# PAP codes (RFC 1334)
PAP_AUTH_REQ = 1
PAP_AUTH_ACK = 2
PAP_AUTH_NAK = 3

# CHAP codes (RFC 1994)
CHAP_CHALLENGE = 1
CHAP_RESPONSE = 2
CHAP_SUCCESS = 3
CHAP_FAILURE = 4


def chap_md5(ident: int, secret: bytes, challenge: bytes) -> bytes:
    """RFC 1994 §4.1: MD5(id || secret || challenge)."""
    return hashlib.md5(bytes([ident]) + secret + challenge).digest()


@dataclass
class AuthResult:
    ok: bool
    username: str = ""
    reason: str = ""
    # attributes from RADIUS (Framed-IP-Address, policy name, ...) if any
    attributes: dict = field(default_factory=dict)


class CredentialVerifier(Protocol):
    """Backend check — local secrets or RADIUS.

    verify_pap(username, password) and verify_chap(username, ident,
    challenge, response) return AuthResult. A RADIUS-backed verifier maps
    these onto Access-Request with User-Password or CHAP-Password
    (auth.go's radius calls).
    """

    def verify_pap(self, username: str, password: bytes) -> AuthResult: ...

    def verify_chap(self, username: str, ident: int, challenge: bytes,
                    response: bytes) -> AuthResult: ...


class LocalVerifier:
    """In-memory username->secret table (the reference's local auth mode)."""

    def __init__(self, secrets: dict[str, bytes]):
        self._secrets = secrets

    def verify_pap(self, username: str, password: bytes) -> AuthResult:
        want = self._secrets.get(username)
        ok = want is not None and hmac.compare_digest(want, password)
        return AuthResult(ok=ok, username=username,
                          reason="" if ok else "bad credentials")

    def verify_chap(self, username: str, ident: int, challenge: bytes,
                    response: bytes) -> AuthResult:
        want = self._secrets.get(username)
        if want is None:
            return AuthResult(ok=False, username=username, reason="unknown user")
        ok = hmac.compare_digest(chap_md5(ident, want, challenge), response)
        return AuthResult(ok=ok, username=username,
                          reason="" if ok else "bad chap response")


class RadiusVerifier:
    """CredentialVerifier over a control.radius.client.RadiusClient
    (auth.go's RADIUS mode): PAP maps to User-Password Access-Requests,
    CHAP to CHAP-Password/CHAP-Challenge (client.authenticate_chap).
    RADIUS attributes (Framed-IP, Filter-Id policy, Session-Timeout)
    ride back in AuthResult.attributes for the session-open hooks."""

    def __init__(self, client, mac_source=None):
        self.client = client
        # optional callable returning the CURRENT client MAC for
        # Calling-Station-Id (the PPPoE server verifies per-frame; the
        # verifier protocol doesn't carry the MAC)
        self.mac_source = mac_source or (lambda: b"")

    @staticmethod
    def _result(username: str, res) -> AuthResult:
        if res is None:  # every server timed out — fail closed
            return AuthResult(ok=False, username=username,
                              reason="radius timeout")
        if not res.success:
            return AuthResult(ok=False, username=username,
                              reason=res.reply_message or "radius reject")
        return AuthResult(ok=True, username=username, attributes={
            "framed_ip": res.framed_ip,
            "qos_policy": res.policy_name,
            "session_timeout": res.session_timeout,
            "idle_timeout": res.idle_timeout,
            "radius_class": res.radius_class,
        })

    def verify_pap(self, username: str, password: bytes) -> AuthResult:
        # raw bytes through: PAP passwords are arbitrary octets (RFC 1334)
        res = self.client.authenticate(username, password,
                                       mac=self.mac_source())
        return self._result(username, res)

    def verify_chap(self, username: str, ident: int, challenge: bytes,
                    response: bytes) -> AuthResult:
        res = self.client.authenticate_chap(username, ident, challenge,
                                            response, mac=self.mac_source())
        return self._result(username, res)


@dataclass
class RateLimiter:
    """Per-key auth attempt limiter (parity: auth.go:542-564)."""

    max_attempts: int = 5
    window_s: float = 60.0
    _attempts: dict[str, list[float]] = field(default_factory=dict)

    def allow(self, key: str, now: float) -> bool:
        lst = self._attempts.setdefault(key, [])
        lst[:] = [t for t in lst if now - t < self.window_s]
        if len(lst) >= self.max_attempts:
            return False
        lst.append(now)
        return True

    def reset(self, key: str) -> None:
        self._attempts.pop(key, None)


class PAPHandler:
    """Parses Auth-Request, verifies, emits Ack/Nak body bytes."""

    def __init__(self, verifier: CredentialVerifier,
                 limiter: RateLimiter | None = None):
        self.verifier = verifier
        self.limiter = limiter or RateLimiter()

    def handle(self, body: bytes, key: str, now: float
               ) -> tuple[bytes | None, AuthResult]:
        """body = PAP packet; returns (reply_packet, result)."""
        if len(body) < 4:
            return None, AuthResult(ok=False, reason="truncated")
        code, ident, length = body[0], body[1], struct.unpack(">H", body[2:4])[0]
        if code != PAP_AUTH_REQ or length > len(body):
            return None, AuthResult(ok=False, reason="not an auth-request")
        p = body[4:length]
        if not p:
            return None, AuthResult(ok=False, reason="empty")
        ulen = p[0]
        if 1 + ulen >= len(p):
            return None, AuthResult(ok=False, reason="bad peer-id length")
        username = p[1 : 1 + ulen].decode("utf-8", "replace")
        plen = p[1 + ulen]
        password = bytearray(p[2 + ulen : 2 + ulen + plen])
        try:
            if not self.limiter.allow(key, now):
                res = AuthResult(ok=False, username=username, reason="rate limited")
            else:
                res = self.verifier.verify_pap(username, bytes(password))
        finally:
            for i in range(len(password)):  # zero the secret (auth.go:580)
                password[i] = 0
        msg = b"" if res.ok else res.reason.encode()[:255]
        reply_code = PAP_AUTH_ACK if res.ok else PAP_AUTH_NAK
        reply = struct.pack(">BBH", reply_code, ident, 5 + len(msg)) + \
            bytes([len(msg)]) + msg
        return reply, res


class CHAPHandler:
    """Server-side CHAP: send a challenge, verify the response.

    Challenge bytes come from an injected source so tests are
    deterministic (the reference uses crypto/rand).
    """

    def __init__(self, verifier: CredentialVerifier, ac_name: str = "bng-tpu",
                 challenge_source: Callable[[], bytes] | None = None,
                 limiter: RateLimiter | None = None):
        self.verifier = verifier
        self.ac_name = ac_name
        self._mkchallenge = challenge_source or self._default_challenge
        self.limiter = limiter or RateLimiter()
        self._counter = 0

    def _default_challenge(self) -> bytes:
        import os

        return os.urandom(16)

    def make_challenge(self, ident: int) -> tuple[bytes, bytes]:
        """Returns (challenge_value, chap_packet)."""
        val = self._mkchallenge()
        name = self.ac_name.encode()
        body = bytes([len(val)]) + val + name
        pkt = struct.pack(">BBH", CHAP_CHALLENGE, ident, 4 + len(body)) + body
        return val, pkt

    def handle_response(self, body: bytes, challenge: bytes, key: str,
                        now: float) -> tuple[bytes | None, AuthResult]:
        if len(body) < 5:
            return None, AuthResult(ok=False, reason="truncated")
        code, ident, length = body[0], body[1], struct.unpack(">H", body[2:4])[0]
        if code != CHAP_RESPONSE or length > len(body):
            return None, AuthResult(ok=False, reason="not a chap response")
        p = body[4:length]
        if not p:
            return None, AuthResult(ok=False, reason="empty response")
        vlen = p[0]
        if 1 + vlen > len(p):
            return None, AuthResult(ok=False, reason="bad value length")
        value = p[1 : 1 + vlen]
        username = p[1 + vlen :].decode("utf-8", "replace")
        if not self.limiter.allow(key, now):
            res = AuthResult(ok=False, username=username, reason="rate limited")
        else:
            res = self.verifier.verify_chap(username, ident, challenge, value)
        if res.ok:
            msg = b"Welcome"
            reply = struct.pack(">BBH", CHAP_SUCCESS, ident, 4 + len(msg)) + msg
        else:
            msg = res.reason.encode()[:64] or b"Authentication failed"
            reply = struct.pack(">BBH", CHAP_FAILURE, ident, 4 + len(msg)) + msg
        return reply, res
