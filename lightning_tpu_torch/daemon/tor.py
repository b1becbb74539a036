"""Tor support: SOCKS5 outbound dialing + hidden-service provisioning.

Parity targets: the reference's connectd/tor.c (the SOCKS5 v5 connect
dance connectd runs for .onion / proxied peers) and
connectd/tor_autoservice.c (the control-port ADD_ONION flow behind
lightningd's --addr=autotor: option).

The tests drive both halves against in-process mocks speaking the real
protocols (a relaying SOCKS5 server, a scripted control port): the same
bytes a real tor would exchange.  The port's own copy of the JAX
package's daemon/tor.py.
"""
from __future__ import annotations

import asyncio
import logging

log = logging.getLogger("lightning_tpu_torch.tor")

SOCKS5_VERSION = 5
AUTH_NONE = 0x00
AUTH_USERPASS = 0x02
CMD_CONNECT = 0x01
ATYP_IPV4 = 0x01
ATYP_DOMAIN = 0x03
ATYP_IPV6 = 0x04

_REPLY_ERR = {
    0x01: "general SOCKS server failure",
    0x02: "connection not allowed by ruleset",
    0x03: "network unreachable",
    0x04: "host unreachable",
    0x05: "connection refused",
    0x06: "TTL expired",
    0x07: "command not supported",
    0x08: "address type not supported",
}


class TorError(Exception):
    pass


async def socks5_connect(proxy_host: str, proxy_port: int,
                         dest_host: str, dest_port: int,
                         username: str | None = None,
                         password: str | None = None,
                         timeout: float = 30.0):
    """RFC1928 CONNECT through a SOCKS5 proxy (tor.c do_socks5 dance):
    greeting → (optional RFC1929 user/pass auth) → CONNECT with a
    DOMAIN address (tor resolves .onion itself — never resolve
    locally).  Returns the (reader, writer) of the tunneled stream."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(proxy_host, proxy_port), timeout)
    try:
        methods = bytes([AUTH_NONE]) if username is None \
            else bytes([AUTH_NONE, AUTH_USERPASS])
        writer.write(bytes([SOCKS5_VERSION, len(methods)]) + methods)
        await writer.drain()
        ver, method = await asyncio.wait_for(reader.readexactly(2),
                                             timeout)
        if ver != SOCKS5_VERSION:
            raise TorError(f"not a SOCKS5 proxy (version {ver})")
        if method == AUTH_USERPASS:
            if username is None:
                raise TorError("proxy demands auth; none configured")
            u, p = username.encode(), (password or "").encode()
            writer.write(bytes([1, len(u)]) + u + bytes([len(p)]) + p)
            await writer.drain()
            _ver, status = await asyncio.wait_for(
                reader.readexactly(2), timeout)
            if status != 0:
                raise TorError("proxy rejected credentials")
        elif method != AUTH_NONE:
            raise TorError(f"no acceptable auth method (got {method})")

        dest = dest_host.encode("idna" if not dest_host.endswith(".onion")
                                else "ascii")
        writer.write(bytes([SOCKS5_VERSION, CMD_CONNECT, 0, ATYP_DOMAIN,
                            len(dest)]) + dest
                     + dest_port.to_bytes(2, "big"))
        await writer.drain()
        ver, rep, _rsv, atyp = await asyncio.wait_for(
            reader.readexactly(4), timeout)
        if rep != 0:
            raise TorError(f"SOCKS5 connect failed: "
                           f"{_REPLY_ERR.get(rep, rep)}")
        # consume the bind address
        if atyp == ATYP_IPV4:
            await reader.readexactly(4 + 2)
        elif atyp == ATYP_IPV6:
            await reader.readexactly(16 + 2)
        elif atyp == ATYP_DOMAIN:
            (ln,) = await reader.readexactly(1)
            await reader.readexactly(ln + 2)
        else:
            raise TorError(f"bad bind atyp {atyp}")
        return reader, writer
    except BaseException:
        writer.close()
        raise


class TorController:
    """Minimal tor control-port client for hidden-service provisioning
    (tor_autoservice.c): PROTOCOLINFO → AUTHENTICATE → ADD_ONION."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9051,
                 password: str | None = None):
        self.host = host
        self.port = port
        self.password = password
        self._reader = None
        self._writer = None

    async def connect(self) -> "TorController":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def _cmd(self, line: str) -> list[str]:
        self._writer.write((line + "\r\n").encode())
        await self._writer.drain()
        out = []
        while True:
            raw = await asyncio.wait_for(self._reader.readline(), 30)
            if not raw:
                raise TorError("control port closed")
            s = raw.decode().rstrip("\r\n")
            out.append(s)
            if len(s) >= 4 and s[3] == " ":   # final reply line
                code = s[:3]
                if not code.startswith("2"):
                    raise TorError(f"control command failed: {s}")
                return out

    async def authenticate(self) -> None:
        """Password auth when configured; otherwise PROTOCOLINFO-driven
        cookie auth (the default tor setup: CookieAuthentication 1),
        falling back to NULL auth on an open control port."""
        if self.password is not None:
            await self._cmd(f'AUTHENTICATE "{self.password}"')
            return
        cookie = None
        try:
            lines = await self._cmd("PROTOCOLINFO 1")
            for s in lines:
                body = s[4:]
                if body.startswith("AUTH ") and "COOKIEFILE=" in body:
                    path = body.split('COOKIEFILE="', 1)[1].split('"')[0]
                    # the cookie can live on slow media (NFS homedirs);
                    # never read it on the event loop
                    cookie = await asyncio.to_thread(
                        lambda p: open(p, "rb").read(), path)
        except (TorError, OSError):
            cookie = None
        if cookie is not None:
            await self._cmd(f"AUTHENTICATE {cookie.hex()}")
        else:
            await self._cmd("AUTHENTICATE")

    async def add_onion(self, virt_port: int, target_host: str,
                        target_port: int,
                        key: str = "NEW:ED25519-V3") -> dict:
        """ADD_ONION: provision a v3 hidden service forwarding
        virt_port → target.  Returns {service_id, onion, private_key}
        (tor_autoservice.c make_onion_service)."""
        lines = await self._cmd(
            f"ADD_ONION {key} Port={virt_port},"
            f"{target_host}:{target_port}")
        sid = pk = None
        for s in lines:
            body = s[4:]
            if body.startswith("ServiceID="):
                sid = body.split("=", 1)[1]
            elif body.startswith("PrivateKey="):
                pk = body.split("=", 1)[1]
        if sid is None:
            raise TorError("ADD_ONION returned no ServiceID")
        return {"service_id": sid, "onion": f"{sid}.onion:{virt_port}",
                "private_key": pk}

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
