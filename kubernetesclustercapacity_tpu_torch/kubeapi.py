"""Stdlib-only Kubernetes API client — live-cluster snapshot ingestion.

Counterpart of ``kubernetesclustercapacity_tpu/kubeapi.py`` (the port's
own copy: stdlib HTTP plus a lazy PyYAML import for the kubeconfig).

The reference bootstraps ``k8s.io/client-go`` from a kubeconfig
(``ClusterCapacity.go:88-97``, ``$HOME`` fallback at ``:152-157``) and then
issues ``1 + 2N + ΣP`` sequential requests (SURVEY.md §3.4).  This module is
the new framework's C2 equivalent with two deliberate differences:

* **no Kubernetes client dependency** — TLS, auth, transport, and
  pagination are pure stdlib (``ssl``/``http.client``); the only import
  beyond the stdlib is PyYAML for the kubeconfig file itself (the optional
  ``kubernetes`` package, when present, is used instead purely for its
  broader auth-provider support);
* **exactly TWO paginated List calls** — ``GET /api/v1/nodes`` and
  ``GET /api/v1/pods`` — then all packing is local, fixing the reference's
  N+1 query pattern.

Auth support: bearer token (inline or ``tokenFile``), client certificates
(inline base64 ``*-data`` or file paths), HTTP basic auth, ``exec``
credential plugins (the EKS/GKE pattern), and the ``oidc`` auth-provider
stanza including token *refresh* (a fresh id-token is fetched through the
issuer's discovery + token endpoints when the cached one is expired).
TLS verifies against the cluster's ``certificate-authority(-data)``
unless ``insecure-skip-tls-verify`` is set.  ``HTTPS_PROXY`` /
``NO_PROXY`` are honored for the apiserver connection (CONNECT
tunneling; the OIDC refresh request goes through ``urllib`` which obeys
them natively).

Known limits vs client-go's stack (recorded in PARITY.md "Architecture
divergences"): the legacy ``azure``/``gcp`` auth-provider stanzas are
rejected with a pointer to exec plugins (client-go removed them in
v1.26), and plain-``http`` apiservers do not proxy (real apiservers are
https).
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import ssl
import subprocess
import tempfile
import time
import urllib.parse
import urllib.request

__all__ = [
    "KubeConfigError",
    "KubeAPIError",
    "KubeConfig",
    "KubeClient",
    "default_kubeconfig_path",
    "default_kubeconfig_paths",
    "live_fixture",
    "node_to_fixture",
    "pod_to_fixture",
]


# Watch liveness watchdog: client read timeout = timeoutSeconds + this.
# The server must end the window within timeoutSeconds; the grace covers
# scheduling/transit slack before a silent dead peer is declared.
_WATCH_GRACE_SECONDS = 30.0


class KubeConfigError(ValueError):
    """Unusable kubeconfig (missing file/context/credentials)."""


class KubeAPIError(RuntimeError):
    """Non-2xx apiserver response or transport failure.

    ``status`` carries the HTTP status (or a watch ERROR event's ``code``)
    when one exists — consumers distinguish e.g. 410 Gone (relist
    required) from transport loss (re-watch suffices).
    """

    def __init__(self, message: str, *, status: int | None = None) -> None:
        super().__init__(message)
        self.status = status


def default_kubeconfig_paths() -> list[str]:
    """``$KUBECONFIG`` entries if set (all of them — client-go merges the
    list), else ``$HOME/.kube/config`` with the reference's HOME/USERPROFILE
    fallback (``ClusterCapacity.go:152-157``)."""
    env = os.environ.get("KUBECONFIG")
    if env:
        return [p for p in env.split(os.pathsep) if p]
    home = os.environ.get("HOME") or os.environ.get("USERPROFILE") or ""
    return [os.path.join(home, ".kube", "config")] if home else []


def default_kubeconfig_path() -> str:
    """First default path entry — display/single-file use; :meth:`KubeConfig.
    load` merges every entry like client-go does."""
    paths = default_kubeconfig_paths()
    return paths[0] if paths else ""


def _b64_or_file(data_b64: str | None, path: str | None, what: str) -> bytes | None:
    if data_b64:
        try:
            return base64.b64decode(data_b64)
        except Exception as e:
            raise KubeConfigError(f"invalid base64 in {what}-data: {e}") from e
    if path:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:
            raise KubeConfigError(f"cannot read {what} file {path}: {e}") from e
    return None


class KubeConfig:
    """The subset of a kubeconfig one context needs: server + TLS + creds."""

    def __init__(
        self,
        server: str,
        *,
        ca_pem: bytes | None = None,
        insecure: bool = False,
        client_cert_pem: bytes | None = None,
        client_key_pem: bytes | None = None,
        token: str | None = None,
        username: str | None = None,
        password: str | None = None,
    ):
        self.server = server.rstrip("/")
        self.ca_pem = ca_pem
        self.insecure = insecure
        self.client_cert_pem = client_cert_pem
        self.client_key_pem = client_key_pem
        self.token = token
        self.username = username
        self.password = password

    @classmethod
    def load(cls, path: str | None = None, context: str | None = None) -> "KubeConfig":
        """Parse a kubeconfig file and resolve one context to credentials."""
        try:
            import yaml
        except ImportError as e:  # pragma: no cover - yaml is baked in here
            raise KubeConfigError(
                "live-cluster ingestion needs PyYAML to read the kubeconfig "
                "(pip install pyyaml), or use snapshot_from_fixture()/"
                "load_snapshot() for offline operation"
            ) from e

        # client-go merge semantics: an explicit path is a single file
        # (missing → error); $KUBECONFIG lists several, missing entries are
        # skipped, and for every map (contexts/clusters/users by name,
        # current-context) the FIRST file to define a key wins.
        if path:
            paths = [path]
        else:
            paths = default_kubeconfig_paths()
        docs: list[tuple[str, dict]] = []
        for p in paths:
            if not os.path.exists(p):
                if path:  # explicit single file must exist
                    raise KubeConfigError(f"kubeconfig not found: {p!r}")
                continue
            with open(p) as f:
                try:
                    docs.append((p, yaml.safe_load(f) or {}))
                except yaml.YAMLError as e:
                    raise KubeConfigError(
                        f"cannot parse kubeconfig {p}: {e}"
                    ) from e
        if not docs:
            raise KubeConfigError(
                f"kubeconfig not found: {paths if paths else '(no path)'}"
            )

        def by_name(section: str, name: str) -> tuple[dict, str, dict]:
            """First entry named ``name`` across the merged files — returns
            ``(body, owning_path, owning_doc)`` so credential write-backs
            land in the file that defined the stanza."""
            for p, d in docs:
                for entry in d.get(section) or []:
                    if entry.get("name") == name:
                        return entry.get(section.rstrip("s"), {}) or {}, p, d
            raise KubeConfigError(
                f"kubeconfig has no {section[:-1]} named {name!r}"
            )

        ctx_name = context or next(
            (d.get("current-context") for _, d in docs
             if d.get("current-context")),
            None,
        )
        if not ctx_name:
            raise KubeConfigError("kubeconfig has no current-context")
        ctx, _, _ = by_name("contexts", ctx_name)
        cluster, _, _ = by_name("clusters", ctx.get("cluster", ""))
        user, user_path, user_doc = (
            by_name("users", ctx.get("user", ""))
            if ctx.get("user")
            else ({}, docs[0][0], docs[0][1])
        )

        server = cluster.get("server")
        if not server:
            raise KubeConfigError(f"context {ctx_name!r}: cluster has no server")

        token = user.get("token")
        if not token and user.get("tokenFile"):
            token = _b64_or_file(None, user["tokenFile"], "token")
            token = token.decode().strip() if token else None
        if not token and user.get("exec"):
            token = _exec_credential_token(user["exec"])
        # The auth-provider stanza is consulted only when no other working
        # credential exists: a leftover legacy stanza next to client certs
        # or basic auth (common in old GKE kubeconfigs) must not block a
        # cluster that is otherwise reachable.
        has_cert = bool(
            user.get("client-certificate-data")
            or user.get("client-certificate")
        )
        has_basic = (
            user.get("username") is not None
            and user.get("password") is not None
        )
        if (
            not token
            and not has_cert
            and not has_basic
            and user.get("auth-provider")
        ):
            provider = user["auth-provider"] or {}
            name = provider.get("name")
            if name == "oidc":

                def _persist(new_id: str, new_refresh: str | None) -> None:
                    # client-go's oidc plugin persists rotated tokens back
                    # into the kubeconfig; IdPs with refresh-token rotation
                    # invalidate the old one on first use, so dropping the
                    # rotation would brick every later run.  `provider` is
                    # a live reference into the FILE that defined the user
                    # stanza (`user_doc`/`user_path` — under $KUBECONFIG
                    # merging that may not be the first file).  Write
                    # atomically (temp file + rename in the same
                    # directory): an in-place truncating write that dies
                    # mid-dump would destroy the kubeconfig — which holds
                    # credentials for every cluster — with the old refresh
                    # token already consumed server-side.
                    block = provider.setdefault("config", {})
                    block["id-token"] = new_id
                    if new_refresh:
                        block["refresh-token"] = new_refresh
                    try:
                        d = os.path.dirname(os.path.abspath(user_path))
                        fd, tmp = tempfile.mkstemp(
                            dir=d, prefix=".kubeconfig-"
                        )
                        try:
                            with os.fdopen(fd, "w") as f:
                                yaml.safe_dump(user_doc, f)
                            os.replace(tmp, user_path)
                        except BaseException:
                            os.unlink(tmp)
                            raise
                    except OSError as e:
                        # Read-only kubeconfig: this run still gets the
                        # fresh token, but a rotated refresh token is now
                        # LOST — say so, or the next run's invalid_grant
                        # is undiagnosable.
                        import sys

                        print(
                            "warning: could not persist refreshed OIDC "
                            f"tokens to {user_path}: {e} (if your IdP "
                            "rotates refresh tokens, the next run will "
                            "need to re-authenticate)",
                            file=sys.stderr,
                        )

                token = _oidc_id_token(
                    provider.get("config") or {}, persist=_persist
                )
            else:
                raise KubeConfigError(
                    f"unsupported auth-provider {name!r} (the legacy "
                    "azure/gcp providers were removed from client-go in "
                    "v1.26 — migrate the kubeconfig to an exec plugin)"
                )

        client_cert_pem = _b64_or_file(
            user.get("client-certificate-data"),
            user.get("client-certificate"),
            "client-certificate",
        )
        client_key_pem = _b64_or_file(
            user.get("client-key-data"), user.get("client-key"), "client-key"
        )
        if bool(client_cert_pem) != bool(client_key_pem):
            # A half-present mTLS credential must fail loudly (client-go:
            # "client-cert specified without client-key") — silently
            # connecting anonymously turns a config typo into an opaque
            # 401 from the apiserver.
            have, missing = (
                ("client-certificate", "client-key")
                if client_cert_pem
                else ("client-key", "client-certificate")
            )
            raise KubeConfigError(
                f"kubeconfig user has {have} but no {missing}"
            )
        return cls(
            server,
            ca_pem=_b64_or_file(
                cluster.get("certificate-authority-data"),
                cluster.get("certificate-authority"),
                "certificate-authority",
            ),
            insecure=bool(cluster.get("insecure-skip-tls-verify")),
            client_cert_pem=client_cert_pem,
            client_key_pem=client_key_pem,
            token=token,
            username=user.get("username"),
            password=user.get("password"),
        )

    def ssl_context(self) -> ssl.SSLContext:
        # A kubeconfig CA is the ONLY trust root (client-go semantics):
        # create_default_context(cadata=...) skips the system store, so a
        # publicly-trusted interception cert for the apiserver host fails
        # closed instead of silently receiving the bearer credentials.
        if self.ca_pem and not self.insecure:
            ctx = ssl.create_default_context(cadata=_cadata(self.ca_pem))
        else:
            ctx = ssl.create_default_context()
        if self.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.client_cert_pem and self.client_key_pem:
            # load_cert_chain only takes paths; stage the PEMs in a private
            # temp dir for the duration of the load.
            with tempfile.TemporaryDirectory() as d:
                cert_p = os.path.join(d, "client.crt")
                key_p = os.path.join(d, "client.key")
                with open(cert_p, "wb") as f:
                    f.write(self.client_cert_pem)
                with open(key_p, "wb") as f:
                    f.write(self.client_key_pem)
                os.chmod(key_p, 0o600)
                ctx.load_cert_chain(cert_p, key_p)
        return ctx

    def auth_headers(self) -> dict:
        if self.token:
            return {"Authorization": f"Bearer {self.token}"}
        if self.username is not None and self.password is not None:
            basic = base64.b64encode(
                f"{self.username}:{self.password}".encode()
            ).decode()
            return {"Authorization": f"Basic {basic}"}
        return {}


def _cadata(ca: bytes):
    """``load_verify_locations``-ready CA material: PEM decodes to str,
    anything undecodable is passed as bytes (DER) — never an uncaught
    UnicodeDecodeError for a Windows-exported ``.cer``."""
    try:
        return ca.decode()
    except UnicodeDecodeError:
        return ca


def _exec_credential_token(spec: dict) -> str:
    """Run a client-go ``exec`` credential plugin and return its token."""
    cmd = [spec.get("command", "")] + list(spec.get("args") or [])
    env = dict(os.environ)
    for pair in spec.get("env") or []:
        env[pair.get("name", "")] = pair.get("value", "")
    # Always OVERWRITE (client-go does): a stale KUBERNETES_EXEC_INFO
    # inherited from the parent environment must not steer the plugin to
    # another cluster/apiVersion.
    env["KUBERNETES_EXEC_INFO"] = (
        json.dumps(
            {
                "apiVersion": spec.get(
                    "apiVersion", "client.authentication.k8s.io/v1"
                ),
                "kind": "ExecCredential",
                "spec": {"interactive": False},
            }
        )
    )
    try:
        out = subprocess.run(
            cmd, env=env, capture_output=True, timeout=60, check=True
        ).stdout
        cred = json.loads(out)
        token = cred.get("status", {}).get("token")
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        # The plugin's own stderr is the actionable diagnostic ("Unable to
        # locate credentials...") — client-go passes it through; so do we.
        stderr = getattr(e, "stderr", b"") or b""
        detail = stderr.decode(errors="replace").strip()
        raise KubeConfigError(
            "exec credential plugin failed: "
            f"{e}{': ' + detail if detail else ''}"
        ) from e
    if not token:
        raise KubeConfigError("exec credential plugin returned no status.token")
    return str(token)


def _jwt_expired(token: str, *, skew_s: float = 30.0) -> bool:
    """True iff the JWT's ``exp`` claim is within ``skew_s`` of now.

    Claims are decoded WITHOUT signature verification — expiry here only
    decides whether to spend a refresh round-trip (client-go's oidc plugin
    does the same); the apiserver is the party that verifies the token.
    A token that does not parse as a JWT is treated as expired (refresh).
    """
    try:
        payload_b64 = token.split(".")[1]
        payload_b64 += "=" * (-len(payload_b64) % 4)
        claims = json.loads(base64.urlsafe_b64decode(payload_b64))
        exp = float(claims["exp"])
    except (IndexError, KeyError, ValueError, TypeError):
        return True
    return exp - skew_s <= time.time()


def _oidc_ssl_context(cfg: dict) -> ssl.SSLContext:
    ca = _b64_or_file(
        cfg.get("idp-certificate-authority-data"),
        cfg.get("idp-certificate-authority"),
        "idp-certificate-authority",
    )
    if ca:  # pinned: the idp CA is the only root (see ssl_context)
        return ssl.create_default_context(cadata=_cadata(ca))
    return ssl.create_default_context()


def _oidc_http_json(
    url: str, ctx: ssl.SSLContext, data: bytes | None = None
) -> dict:
    """GET/POST JSON from the identity provider (urllib honors
    HTTP(S)_PROXY/NO_PROXY natively, matching the transport the refreshed
    token will ultimately ride)."""
    req = urllib.request.Request(
        url,
        data=data,
        headers=(
            {"Content-Type": "application/x-www-form-urlencoded"}
            if data is not None
            else {}
        ),
    )
    try:
        with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError) as e:
        raise KubeConfigError(f"OIDC request to {url} failed: {e}") from e


def _oidc_id_token(cfg: dict, persist=None) -> str:
    """client-go's ``oidc`` auth-provider: cached id-token, refreshed when
    expired via OIDC discovery + the token endpoint.

    ``persist(new_id_token, new_refresh_token_or_None)`` is invoked after a
    successful refresh so the caller can write rotated tokens back to the
    kubeconfig (rotation-enabled IdPs invalidate the consumed refresh
    token; without write-back every later run would fail invalid_grant).
    """
    id_token = cfg.get("id-token")
    if id_token and not _jwt_expired(str(id_token)):
        return str(id_token)
    issuer = (cfg.get("idp-issuer-url") or "").rstrip("/")
    refresh = cfg.get("refresh-token")
    if not issuer or not refresh:
        raise KubeConfigError(
            "oidc auth-provider: id-token expired or absent and no "
            "idp-issuer-url + refresh-token to refresh with"
        )
    ctx = _oidc_ssl_context(cfg)
    discovery = _oidc_http_json(
        issuer + "/.well-known/openid-configuration", ctx
    )
    endpoint = discovery.get("token_endpoint")
    if not endpoint:
        raise KubeConfigError(
            "oidc auth-provider: issuer discovery has no token_endpoint"
        )
    # Empty client_id/client_secret are OMITTED, not sent blank: strict
    # IdPs treat a present client_secret as secret-based client auth and
    # reject public clients (x/oauth2, which client-go uses, omits too).
    fields = {
        "grant_type": "refresh_token",
        "refresh_token": refresh,
        "client_id": cfg.get("client-id"),
        "client_secret": cfg.get("client-secret"),
    }
    form = urllib.parse.urlencode(
        {k: v for k, v in fields.items() if v}
    ).encode()
    tokens = _oidc_http_json(endpoint, ctx, data=form)
    fresh = tokens.get("id_token")
    if not fresh:
        raise KubeConfigError(
            "oidc auth-provider: token endpoint returned no id_token"
        )
    if persist is not None:
        persist(str(fresh), tokens.get("refresh_token"))
    return str(fresh)


def _proxy_for(scheme: str, host: str, port: int) -> str | None:
    """The proxy URL to tunnel through, or None (honors NO_PROXY).

    The bypass probe carries the port: urllib only matches a ported
    NO_PROXY entry (``api.example:6443``) when the probe string does too.
    """
    try:
        if urllib.request.proxy_bypass(f"{host}:{port}"):
            return None
    except OSError:  # pragma: no cover - platform lookup failure
        pass
    return urllib.request.getproxies().get(scheme)


class KubeClient:
    """Minimal apiserver GET client with pagination over a kubeconfig."""

    def __init__(self, config: KubeConfig, *, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        u = urllib.parse.urlsplit(config.server)
        if u.scheme not in ("http", "https"):
            raise KubeConfigError(f"unsupported server scheme: {config.server!r}")
        self._scheme = u.scheme
        self._host = u.hostname or ""
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._prefix = u.path.rstrip("/")
        self._ssl = config.ssl_context() if u.scheme == "https" else None
        self._conn: http.client.HTTPConnection | None = None

    def _connect(
        self, *, timeout: float | None = -1.0
    ) -> http.client.HTTPConnection:
        if timeout == -1.0:
            timeout = self.timeout
        if self._scheme == "https":
            proxy = _proxy_for("https", self._host, self._port)
            if proxy:
                # CONNECT tunnel: TCP (+ optional basic auth) to the proxy,
                # then TLS end-to-end to the apiserver through it — the
                # proxy never sees plaintext.
                pu = urllib.parse.urlsplit(proxy)
                if not pu.hostname:  # "host:port" with no scheme
                    pu = urllib.parse.urlsplit("http://" + proxy)
                if pu.scheme == "https":
                    # set_tunnel sends the CONNECT in plaintext before any
                    # TLS wrap; a TLS-terminating proxy would hang/reset
                    # opaquely — fail with a diagnosis instead.
                    raise KubeConfigError(
                        f"HTTPS_PROXY {proxy!r}: TLS-to-proxy is not "
                        "supported; use an http:// CONNECT proxy"
                    )
                headers = {}
                if pu.username:
                    cred = (
                        f"{urllib.parse.unquote(pu.username)}:"
                        f"{urllib.parse.unquote(pu.password or '')}"
                    )
                    headers["Proxy-Authorization"] = (
                        "Basic " + base64.b64encode(cred.encode()).decode()
                    )
                conn = http.client.HTTPSConnection(
                    pu.hostname or "",
                    # Portless proxy URLs default to 80 like urllib/curl/
                    # client-go (and this module's own OIDC refresh path).
                    pu.port or 80,
                    timeout=timeout,
                    context=self._ssl,
                )
                conn.set_tunnel(self._host, self._port, headers=headers)
                return conn
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._ssl
            )
        return http.client.HTTPConnection(
            self._host, self._port, timeout=timeout
        )

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _get_once(self, url: str) -> tuple[int, str, bytes]:
        if self._conn is None:
            self._conn = self._connect()
        conn = self._conn
        try:
            conn.request(
                "GET",
                url,
                headers={"Accept": "application/json", **self.config.auth_headers()},
            )
            resp = conn.getresponse()
            return resp.status, resp.reason or "", resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            raise

    def get_json(self, path: str, params: dict | None = None) -> dict:
        """GET over a persistent keep-alive connection (one TLS handshake
        per client, not per page); a stale connection is retried once."""
        query = urllib.parse.urlencode(
            {k: v for k, v in (params or {}).items() if v is not None}
        )
        url = self._prefix + path + (f"?{query}" if query else "")
        try:
            fresh = self._conn is None
            try:
                status, reason, body = self._get_once(url)
            except (OSError, http.client.HTTPException):
                if fresh:
                    raise
                # Keep-alive connection idled out since the last page —
                # reconnect once; a failure on a fresh socket is real.
                status, reason, body = self._get_once(url)
        except (OSError, http.client.HTTPException) as e:
            raise KubeAPIError(f"GET {path} failed: {e}") from e
        if status // 100 != 2:
            raise KubeAPIError(
                f"GET {path} -> {status} {reason}: "
                f"{body[:200].decode(errors='replace')}",
                status=status,
            )
        try:
            return json.loads(body)
        except ValueError as e:
            raise KubeAPIError(f"GET {path}: invalid JSON response: {e}") from e

    def _pages(self, path: str, limit: int, field_selector: str | None):
        """Yield ``(items, metadata)`` per page, following ``continue``."""
        token: str | None = None
        while True:
            page = self.get_json(
                path,
                {"limit": limit, "continue": token, "fieldSelector": field_selector},
            )
            meta = page.get("metadata") or {}
            yield page.get("items") or [], meta
            token = meta.get("continue")
            if not token:
                return

    def list_all(
        self, path: str, *, limit: int = 500, field_selector: str | None = None
    ):
        """Paginated List, streamed: one page of raw items in memory at a
        time (a 100k-pod cluster must not be materialized twice)."""
        for items, _ in self._pages(path, limit, field_selector):
            yield from items

    def list_with_version(
        self, path: str, *, limit: int = 500, field_selector: str | None = None
    ) -> tuple[list, str]:
        """Paginated List returning ``(items, resourceVersion)``.

        The resourceVersion of the final page is the point a subsequent
        watch resumes from (the standard list+watch contract).
        """
        items: list = []
        version = ""
        for page_items, meta in self._pages(path, limit, field_selector):
            items.extend(page_items)
            version = meta.get("resourceVersion") or version
        return items, version

    def watch_events(
        self,
        path: str,
        *,
        resource_version: str | None = None,
        field_selector: str | None = None,
        timeout_seconds: int | None = 300,
        read_timeout: float | None = None,
    ):
        """Stream watch events for one resource until the server ends it.

        Yields the decoded ``{"type": ..., "object": ...}`` dicts of the
        Kubernetes watch protocol (newline-delimited JSON over a chunked
        response).  The generator exits when the server closes the stream;
        callers re-watch from the last seen
        ``object.metadata.resourceVersion``.  A dedicated client should own
        a watch — the connection is occupied for the stream's lifetime.

        Idle-cluster handling: the window is bounded *server-side* via
        ``timeoutSeconds`` (which ends the stream cleanly), and the client
        socket carries a read timeout of ``timeoutSeconds`` plus a grace
        period as a liveness watchdog — if the apiserver or an LB dies
        without sending FIN, the server-side bound can never fire, and
        without the watchdog a reader would block on the dead socket
        forever.  A watchdog trip *while streaming* is treated as a clean
        end-of-window (the caller re-watches, exactly as after a normal
        window close), not a transport failure; pass ``read_timeout``
        explicitly to override, or ``timeout_seconds=None`` for an
        unbounded watch with no watchdog.
        """
        if read_timeout is None and timeout_seconds is not None:
            read_timeout = timeout_seconds + _WATCH_GRACE_SECONDS
        query = urllib.parse.urlencode(
            {
                k: v
                for k, v in {
                    "watch": "1",
                    "resourceVersion": resource_version,
                    "fieldSelector": field_selector,
                    "allowWatchBookmarks": "true",
                    "timeoutSeconds": timeout_seconds,
                }.items()
                if v is not None
            }
        )
        url = f"{self._prefix}{path}?{query}"
        self.close()  # a watch always runs on its own fresh connection
        conn = self._connect(timeout=read_timeout)
        # Register the stream's connection as the client's: close() from
        # another thread (follower.stop()) must be able to sever a reader
        # blocked in readline() instead of waiting out the watchdog.
        self._conn = conn
        # Transport-error conversion wraps ONLY the transport calls, never
        # a yield: an exception the CONSUMER raises while processing an
        # event re-enters the generator at the yield, and converting it
        # would mask a caller bug as a stream failure.
        try:
            try:
                conn.request(
                    "GET",
                    url,
                    headers={
                        "Accept": "application/json",
                        **self.config.auth_headers(),
                    },
                )
                resp = conn.getresponse()
                if resp.status // 100 != 2:
                    body = resp.read()
                    raise KubeAPIError(
                        f"WATCH {path} -> {resp.status} {resp.reason}: "
                        f"{body[:200].decode(errors='replace')}",
                        status=resp.status,
                    )
            except (OSError, http.client.HTTPException) as e:
                raise KubeAPIError(f"WATCH {path} failed: {e}") from e
            while True:
                try:
                    line = resp.readline()
                except TimeoutError:
                    # Liveness watchdog: the stream outlived timeoutSeconds
                    # + grace, so the server-side window bound is never
                    # coming (dead peer, no FIN).  Clean end-of-window —
                    # the caller re-watches on a fresh connection.
                    return
                except (OSError, http.client.HTTPException, ValueError) as e:
                    # ValueError: readline() on a response another thread
                    # close()d between events ("readline of closed file")
                    # — a severed stream, same taxonomy as a socket error.
                    raise KubeAPIError(f"WATCH {path} failed: {e}") from e
                if not line:
                    return  # server closed the watch window
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError as e:
                    raise KubeAPIError(
                        f"WATCH {path}: invalid event frame: {e}"
                    ) from e
                yield event
        finally:
            conn.close()
            if self._conn is conn:
                self._conn = None


def _containers_fixture(containers: list | None) -> list:
    out = []
    for c in containers or []:
        res = c.get("resources") or {}
        out.append(
            {
                "resources": {
                    "requests": dict(res.get("requests") or {}),
                    "limits": dict(res.get("limits") or {}),
                }
            }
        )
    return out


def node_to_fixture(n: dict) -> dict:
    """K8s REST Node object → the framework's fixture-schema node."""
    status = n.get("status") or {}
    spec = n.get("spec") or {}
    meta = n.get("metadata") or {}
    return {
        "name": meta.get("name", ""),
        "allocatable": {
            k: str(v) for k, v in (status.get("allocatable") or {}).items()
        },
        "conditions": [
            {"type": c.get("type", ""), "status": c.get("status", "")}
            for c in (status.get("conditions") or [])
        ],
        "labels": dict(meta.get("labels") or {}),
        "taints": [
            {
                "key": t.get("key", ""),
                "value": t.get("value", "") or "",
                "effect": t.get("effect", ""),
            }
            for t in (spec.get("taints") or [])
        ],
    }


def pod_to_fixture(p: dict) -> dict:
    """K8s REST Pod object → the framework's fixture-schema pod."""
    meta = p.get("metadata") or {}
    spec = p.get("spec") or {}
    status = p.get("status") or {}
    out = {
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "nodeName": spec.get("nodeName") or "",
        "phase": status.get("phase", ""),
        # Pod labels feed the anti-affinity-vs-existing-pods mask.
        "labels": dict(meta.get("labels") or {}),
        "containers": _containers_fixture(spec.get("containers")),
        "initContainers": _containers_fixture(spec.get("initContainers")),
    }
    # The admission-resolved integer priority feeds preemption-aware
    # capacity (ops/preemption.py); absent stays absent (fixture readers
    # default it to 0, the no-global-default-PriorityClass value).
    if spec.get("priority") is not None:
        out["priority"] = spec["priority"]
    return out


def pdb_to_fixture(b: dict) -> dict:
    """K8s REST PodDisruptionBudget → the fixture-schema pdb dict.

    Exactly one of minAvailable/maxUnavailable survives (the API
    enforces that on its side; :mod:`..pdb` re-validates)."""
    meta = b.get("metadata") or {}
    spec = b.get("spec") or {}
    out = {
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "selector": spec.get("selector") or {},
    }
    for key in ("minAvailable", "maxUnavailable"):
        if spec.get(key) is not None:
            out[key] = spec[key]
    return out


PDB_PATH = "/apis/policy/v1/poddisruptionbudgets"


def list_pdbs(client: "KubeClient", *, page_limit: int = 500) -> list[dict]:
    """List every PDB in fixture schema, degrading to ``[]`` only when
    this principal cannot read the policy API (403) or the apiserver
    lacks it (404) — budgets are an optional safety surface there.
    Transport loss and server errors still raise: silently dropping the
    eviction gate on a flaky connection would turn a PDB-blocked drain
    verdict into "evictable"."""
    try:
        return [
            pdb_to_fixture(b)
            for b in client.list_all(PDB_PATH, limit=page_limit)
        ]
    except KubeAPIError as e:
        if e.status in (403, 404):
            return []
        raise


def live_fixture(
    kubeconfig: str | None = None,
    *,
    context: str | None = None,
    client: KubeClient | None = None,
    page_limit: int = 500,
) -> dict:
    """Snapshot a live cluster into the framework's fixture schema.

    Three paginated Lists total (vs. the reference's ``1 + 2N + ΣP``
    pattern, ``ClusterCapacity.go:168,183,238,264``).  Pods are fetched
    across all namespaces with **no** phase field-selector: phases travel
    in the fixture so reference/strict filtering stays a local, testable
    decision (PARITY.md Q7).  PodDisruptionBudgets feed the drain
    simulator's eviction gate; clusters where the policy API is
    unreadable (403/404) degrade to a budget-less fixture — see
    :func:`list_pdbs`.
    """
    own_client = client is None
    if client is None:
        client = KubeClient(KubeConfig.load(kubeconfig, context=context))

    fixture: dict = {"nodes": [], "pods": []}
    try:
        for n in client.list_all("/api/v1/nodes", limit=page_limit):
            fixture["nodes"].append(node_to_fixture(n))
        for p in client.list_all("/api/v1/pods", limit=page_limit):
            fixture["pods"].append(pod_to_fixture(p))
        pdbs = list_pdbs(client, page_limit=page_limit)
        if pdbs:
            fixture["pdbs"] = pdbs
    finally:
        # Error paths must not leak the TLS connection (a token expiring
        # mid-pagination would otherwise strand a socket per retry).
        if own_client:
            client.close()
    return fixture
