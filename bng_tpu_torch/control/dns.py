"""DNS forwarder/interceptor for the walled garden.

The port's copy of `bng_tpu/control/dns.py` (jax-free).

Parity: pkg/dns — Resolver.Resolve pipeline rate-limit -> intercept ->
walled-garden -> cache -> forward -> DNS64 (resolver.go:116-210), rule
matching with exact/suffix/wildcard (:468-491), redirect/NXDOMAIN/CNAME
responses (:493-531), walled-garden client redirect (:533-554), DNS64
AAAA synthesis from A (:556-596), LRU cache with TTL clamps + negative
cache (cache.go:10-199), per-client-IP token-bucket rate limiting
(resolver.go:623-708), stats (types.go:134-171).

The upstream forwarder is pluggable (a callable), so the resolver is
fully testable without a network — the same inversion the reference gets
from its stub platform pattern (SURVEY.md §4.6).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from enum import Enum

from bng_tpu_torch.utils.structlog import ErrorLog

# DNS constants (types.go:173-221)
TYPE_A = 1
TYPE_NS = 2
TYPE_CNAME = 5
TYPE_AAAA = 28
TYPE_PTR = 12
TYPE_MX = 15
TYPE_TXT = 16
TYPE_SRV = 33
CLASS_IN = 1

RCODE_SUCCESS = 0
RCODE_FORMAT_ERROR = 1
RCODE_SERVER_FAILURE = 2
RCODE_NAME_ERROR = 3  # NXDOMAIN
RCODE_REFUSED = 5

_TYPE_NAMES = {TYPE_A: "A", TYPE_AAAA: "AAAA", TYPE_CNAME: "CNAME",
               TYPE_PTR: "PTR", TYPE_MX: "MX", TYPE_TXT: "TXT"}


def type_string(t: int) -> str:
    return _TYPE_NAMES.get(t, f"TYPE{t}")


class InterceptAction(str, Enum):
    ALLOW = "allow"
    BLOCK = "block"  # NXDOMAIN
    REDIRECT = "redirect"  # answer with a configured IP
    CNAME = "cname"


@dataclass
class Query:
    name: str
    qtype: int = TYPE_A
    qclass: int = CLASS_IN
    source: str = ""  # client IP


@dataclass
class Record:
    name: str
    rtype: int
    rclass: int = CLASS_IN
    ttl: int = 0
    ipv4: str = ""
    ipv6: str = ""
    target: str = ""  # CNAME/NS/PTR target
    # verbatim rdata for other types (TXT, MX, SRV, ...): the wire codec
    # stores a decompressed copy so non-address records survive the
    # forward path instead of being silently dropped
    rdata: bytes = b""


@dataclass
class Response:
    query: Query
    answers: list[Record] = field(default_factory=list)
    rcode: int = RCODE_SUCCESS
    cached: bool = False


@dataclass
class InterceptRule:
    """types.go:223-249."""

    domain: str = ""
    domain_suffix: str = ""
    exact: bool = False
    action: InterceptAction = InterceptAction.ALLOW
    redirect_ip: str = ""
    cname: str = ""


@dataclass
class DNSConfig:
    """types.go:9-79 defaults."""

    upstreams: list[str] = field(default_factory=lambda: ["8.8.8.8:53", "1.1.1.1:53"])
    timeout: float = 5.0
    cache_size: int = 10_000
    min_ttl: int = 60
    max_ttl: int = 86_400
    negative_ttl: int = 300
    dns64_enabled: bool = False
    dns64_prefix: str = "64:ff9b::"  # RFC 6052 well-known /96
    walled_garden_redirect_ip: str = "10.255.255.1"
    rate_limit_qps: int = 100
    rate_limit_burst: int = 200


def cache_key(name: str, qtype: int, qclass: int) -> str:
    """cache.go:196-199."""
    return f"{name.lower().rstrip('.')}/{qtype}/{qclass}"


class DNSCache:
    """LRU cache with TTL clamping + negative cache (cache.go:10-199)."""

    def __init__(self, max_size: int, min_ttl: int, max_ttl: int,
                 negative_ttl: int, clock=time.time):
        self.max_size = max_size
        self.min_ttl = min_ttl
        self.max_ttl = max_ttl
        self.negative_ttl = negative_ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._items: OrderedDict[str, tuple[float, Response | None]] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: str) -> tuple[Response | None, bool]:
        """Returns (response, found). A found None response = negative hit."""
        now = self._clock()
        with self._lock:
            item = self._items.get(key)
            if item is None:
                self._misses += 1
                return None, False
            expires, resp = item
            if now >= expires:
                del self._items[key]
                self._misses += 1
                return None, False
            self._items.move_to_end(key)
            self._hits += 1
            return resp, True

    def set(self, key: str, response: Response) -> None:
        ttl = min(r.ttl for r in response.answers) if response.answers else 0
        ttl = max(self.min_ttl, min(self.max_ttl, ttl))
        self._put(key, self._clock() + ttl, response)

    def set_negative(self, key: str) -> None:
        self._put(key, self._clock() + self.negative_ttl, None)

    def _put(self, key: str, expires: float, resp: Response | None) -> None:
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
            self._items[key] = (expires, resp)
            while len(self._items) > self.max_size:
                self._items.popitem(last=False)
                self._evictions += 1

    def delete(self, key: str) -> None:
        with self._lock:
            self._items.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def cleanup(self) -> int:
        now = self._clock()
        with self._lock:
            dead = [k for k, (exp, _) in self._items.items() if now >= exp]
            for k in dead:
                del self._items[k]
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {"size": len(self._items), "hits": self._hits,
                    "misses": self._misses, "evictions": self._evictions,
                    "hit_rate": self._hits / total if total else 0.0}


class _RateBucket:
    __slots__ = ("tokens", "last")

    def __init__(self, tokens: float, last: float):
        self.tokens = tokens
        self.last = last


class Resolver:
    """The resolve pipeline (resolver.go:116-210)."""

    def __init__(self, config: DNSConfig | None = None, forwarder=None,
                 clock=time.time):
        """forwarder: Callable[[Query], Response] hitting the upstreams."""
        self.config = config or DNSConfig()
        self._forward = forwarder
        self._clock = clock
        self._lock = threading.Lock()
        self.cache = DNSCache(self.config.cache_size, self.config.min_ttl,
                              self.config.max_ttl, self.config.negative_ttl,
                              clock=clock)
        self._rules: list[InterceptRule] = []
        self._walled_clients: set[str] = set()
        self._buckets: dict[str, _RateBucket] = {}
        self._stats = {"queries": 0, "cache_hits": 0, "intercepted": 0,
                       "walled_garden_redirects": 0, "forwarded": 0,
                       "rate_limited": 0, "dns64_synthesized": 0,
                       "errors": 0, "dns64_errors": 0}
        self._dns64_err_log = ErrorLog(
            "dns", "DNS64 synthesis failed; empty AAAA passed through")

    # -- config surface -------------------------------------------------

    def add_intercept_rule(self, rule: InterceptRule) -> None:
        with self._lock:
            self._rules.append(rule)

    def remove_intercept_rule(self, domain: str) -> bool:
        with self._lock:
            before = len(self._rules)
            self._rules = [r for r in self._rules
                           if r.domain != domain and r.domain_suffix != domain]
            return len(self._rules) != before

    def add_walled_garden_client(self, ip: str) -> None:
        with self._lock:
            self._walled_clients.add(ip)

    def remove_walled_garden_client(self, ip: str) -> bool:
        with self._lock:
            had = ip in self._walled_clients
            self._walled_clients.discard(ip)
            return had

    def is_in_walled_garden(self, ip: str) -> bool:
        with self._lock:
            return ip in self._walled_clients

    # -- the pipeline ---------------------------------------------------

    def resolve(self, query: Query) -> Response:
        with self._lock:
            self._stats["queries"] += 1

        # 1. rate limit (resolver.go:131-137)
        if query.source and not self._check_rate_limit(query.source):
            with self._lock:
                self._stats["rate_limited"] += 1
            return Response(query=query, rcode=RCODE_REFUSED)

        # 2. interception rules (resolver.go:140-147)
        action, resp = self._check_intercept(query)
        if action != InterceptAction.ALLOW:
            with self._lock:
                self._stats["intercepted"] += 1
            return resp

        # 3. walled garden clients get the portal for everything
        #    (resolver.go:150-157)
        if query.source and self.is_in_walled_garden(query.source):
            with self._lock:
                self._stats["walled_garden_redirects"] += 1
            return self._walled_garden_answer(query)

        # 4. cache (resolver.go:160-170)
        key = cache_key(query.name, query.qtype, query.qclass)
        cached, found = self.cache.get(key)
        if found:
            with self._lock:
                self._stats["cache_hits"] += 1
            if cached is None:  # negative hit
                return Response(query=query, rcode=RCODE_NAME_ERROR, cached=True)
            return Response(query=query, answers=cached.answers,
                            rcode=cached.rcode, cached=True)

        # 5. forward (resolver.go:173-186)
        if self._forward is None:
            with self._lock:
                self._stats["errors"] += 1
            return Response(query=query, rcode=RCODE_SERVER_FAILURE)
        try:
            resp = self._forward(query)
        except Exception:
            with self._lock:
                self._stats["errors"] += 1
            return Response(query=query, rcode=RCODE_SERVER_FAILURE)
        with self._lock:
            self._stats["forwarded"] += 1

        # 6. DNS64: empty AAAA answer -> synthesize from A (resolver.go:189-199)
        if (self.config.dns64_enabled and query.qtype == TYPE_AAAA
                and not resp.answers and resp.rcode == RCODE_SUCCESS):
            try:
                synth = self._apply_dns64(query)
            except Exception as e:
                # a broken upstream A answer must not kill the resolve,
                # but silent DNS64 breakage hides v6-only outage (BNG021)
                synth = None
                self._stats["dns64_errors"] += 1
                self._dns64_err_log.report(e, qname=query.name)
            if synth is not None:
                resp = synth

        # cache positive + negative outcomes (resolver.go:202-207)
        if resp.answers:
            self.cache.set(key, resp)
        elif resp.rcode == RCODE_NAME_ERROR:
            self.cache.set_negative(key)
        return resp

    # -- pieces ---------------------------------------------------------

    def _check_intercept(self, query: Query):
        with self._lock:
            rules = list(self._rules)
        for rule in rules:
            if not _match_rule(rule, query.name):
                continue
            if rule.action == InterceptAction.BLOCK:
                return rule.action, Response(query=query, rcode=RCODE_NAME_ERROR)
            if rule.action == InterceptAction.REDIRECT:
                return rule.action, _redirect_response(query, rule.redirect_ip)
            if rule.action == InterceptAction.CNAME:
                rec = Record(name=query.name, rtype=TYPE_CNAME,
                             rclass=query.qclass, ttl=300, target=rule.cname)
                return rule.action, Response(query=query, answers=[rec])
        return InterceptAction.ALLOW, None

    def _walled_garden_answer(self, query: Query) -> Response:
        if query.qtype in (TYPE_A, TYPE_AAAA):
            return _redirect_response(query, self.config.walled_garden_redirect_ip)
        return Response(query=query, rcode=RCODE_NAME_ERROR)

    def _apply_dns64(self, query: Query) -> Response | None:
        a_resp = self._forward(Query(name=query.name, qtype=TYPE_A,
                                     qclass=query.qclass, source=query.source))
        if not a_resp.answers:
            return None
        out = Response(query=query)
        for ans in a_resp.answers:
            if ans.rtype != TYPE_A or not ans.ipv4:
                continue
            out.answers.append(Record(
                name=ans.name, rtype=TYPE_AAAA, rclass=ans.rclass, ttl=ans.ttl,
                ipv6=dns64_synthesize(self.config.dns64_prefix, ans.ipv4)))
        if out.answers:
            with self._lock:
                self._stats["dns64_synthesized"] += len(out.answers)
            return out
        return None

    def _check_rate_limit(self, ip: str) -> bool:
        """Token bucket per client IP (resolver.go:623-643)."""
        now = self._clock()
        qps, burst = self.config.rate_limit_qps, self.config.rate_limit_burst
        if qps <= 0:
            return True
        with self._lock:
            b = self._buckets.get(ip)
            if b is None:
                self._buckets[ip] = _RateBucket(burst - 1.0, now)
                return True
            b.tokens = min(burst, b.tokens + (now - b.last) * qps)
            b.last = now
            if b.tokens >= 1.0:
                b.tokens -= 1.0
                return True
            return False

    def cleanup_rate_limiter(self, idle: float = 300.0) -> int:
        now = self._clock()
        with self._lock:
            dead = [ip for ip, b in self._buckets.items() if now - b.last > idle]
            for ip in dead:
                del self._buckets[ip]
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats, cache=self.cache.stats())


def _match_rule(rule: InterceptRule, domain: str) -> bool:
    """resolver.go:468-491: exact / suffix / domain+subdomain wildcard."""
    d = domain.lower().rstrip(".")
    if rule.exact:
        return d == rule.domain.lower().rstrip(".")
    if rule.domain_suffix:
        return d.endswith(rule.domain_suffix.lower().rstrip("."))
    if rule.domain:
        base = rule.domain.lower().rstrip(".")
        return d == base or d.endswith("." + base)
    return False


def _redirect_response(query: Query, ip: str) -> Response:
    rec = Record(name=query.name, rtype=query.qtype, rclass=query.qclass, ttl=300)
    if query.qtype == TYPE_A:
        rec.ipv4 = ip
    elif query.qtype == TYPE_AAAA:
        rec.ipv6 = ip if ":" in ip else dns64_synthesize("64:ff9b::", ip)
    return Response(query=query, answers=[rec])


def dns64_synthesize(prefix: str, ipv4: str) -> str:
    """RFC 6052 /96 synthesis: prefix::a.b.c.d embedded in the low 32 bits."""
    a, b, c, d = (int(x) for x in ipv4.split("."))
    base = prefix.rstrip(":") + "::"
    return f"{base}{(a << 8) | b:x}:{(c << 8) | d:x}"
