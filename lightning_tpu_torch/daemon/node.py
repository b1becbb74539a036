"""LightningNode: listener + dialer + peer registry + init exchange.

Functional parity targets: connectd/connectd.c (listen/dial/peer table)
and connectd/peer_exchange_initmsg.c (BOLT#1 init must be the first
message each way; feature compatibility decides the connection).

Architecture note: the reference fans out one OS process per concern;
here the host plane is one asyncio loop (protocol drivers are
coroutines), because the heavy lifting, signature math, runs on the card
as batched kernels, not in the host processes.  The port's own copy of
the JAX package's daemon/node.py.
"""
from __future__ import annotations

import asyncio
import logging

from ..bolt import noise
from ..wire import codec
from ..wire import messages as M
from . import features as feat
from . import transport as transport_mod
from .peer import Peer
from .transport import NoiseStream, accept_noise, connect_noise

log = logging.getLogger("lightning_tpu_torch.node")

INIT_TIMEOUT = 30.0


class LightningNode:
    """The network identity + peer table of one node."""

    def __init__(self, privkey: int | None = None,
                 features: bytes | None = None):
        self.keypair = (transport_mod.random_keypair() if privkey is None
                        else noise.Keypair(privkey))
        self.features = (features if features is not None
                         else feat.from_bits(feat.DEFAULT_FEATURES))
        self.peers: dict[bytes, Peer] = {}
        self.handlers: dict[type, object] = {}
        self.raw_handlers: dict[int, object] = {}  # msg type -> fn(peer, raw)
        self.on_peer = None  # async callback(peer) run for each new peer
        # fired when a peer's transport dies (reconnect lifecycle hook,
        # connectd.c:86 schedule_reconnect_if_important)
        self.on_peer_gone = None
        self.addresses: dict[bytes, tuple[str, int]] = {}  # last good addr
        self.plugin_host = None  # set by daemon assembly (hooks.py anchor)
        self.tor_proxy: tuple[str, int] | None = None  # SOCKS5 (h, p)
        self._server: asyncio.AbstractServer | None = None
        self._peer_tasks: set[asyncio.Task] = set()
        self.closing = False

    @property
    def node_id(self) -> bytes:
        return self.keypair.pub_bytes

    # -- wiring ----------------------------------------------------------

    def register(self, msg_cls: type, handler) -> None:
        """Route messages of msg_cls to `async handler(peer, msg)` instead
        of the peer inbox."""
        self.handlers[msg_cls] = handler

    # -- listening / dialing ---------------------------------------------

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start accepting connections; returns the bound port."""
        self._server = await asyncio.start_server(self._on_connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            stream = await accept_noise(reader, writer, self.keypair)
        except (noise.HandshakeError, ConnectionError, OSError,
                asyncio.IncompleteReadError, asyncio.TimeoutError, ValueError):
            writer.close()
            return
        try:
            await self._setup_peer(stream, incoming=True)
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, codec.WireError, _InitError,
                noise.HandshakeError):
            await stream.close()

    async def connect(self, host: str, port: int, node_id: bytes,
                      timeout: float = 30.0) -> Peer:
        """Dial, handshake, exchange init.  Returns the live Peer.
        With tor_proxy set (or always for .onion targets) the TCP dial
        rides SOCKS5 (connectd/tor.c)."""
        open_conn = None
        if self.tor_proxy is not None or host.endswith(".onion"):
            if self.tor_proxy is None:
                raise ConnectionError(
                    f"{host} needs a tor proxy (none configured)")
            from . import tor as TOR

            ph, pp = self.tor_proxy
            open_conn = (lambda h, p:
                         TOR.socks5_connect(ph, pp, h, p))
        stream = await asyncio.wait_for(
            connect_noise(host, port, self.keypair, node_id,
                          open_conn=open_conn), timeout
        )
        try:
            peer = await self._setup_peer(stream, incoming=False)
        except BaseException:
            await stream.close()
            raise
        self.addresses[node_id] = (host, port)
        return peer

    # -- init exchange ----------------------------------------------------

    async def _setup_peer(self, stream: NoiseStream, incoming: bool) -> Peer:
        await stream.send_msg(
            M.Init(globalfeatures=b"", features=self.features).serialize()
        )
        their_init = await asyncio.wait_for(self._read_init(stream), INIT_TIMEOUT)
        their_features = feat.combine(their_init.globalfeatures,
                                      their_init.features)
        bad = feat.unsupported_features(self.features, their_features)
        if bad:
            await stream.send_msg(M.Error(
                channel_id=b"\x00" * 32,
                data=f"unsupported features {bad}".encode(),
            ).serialize())
            raise _InitError(f"peer requires unsupported features {bad}")

        node_id = stream.remote_pub_bytes
        old = self.peers.get(node_id)
        if old is not None:
            # reference drops the old connection in favor of the new one
            await old.disconnect()
        # peer_connected hook (connectd → lightningd peer_connected_hook,
        # lightningd/peer_control.c): plugins may disconnect the peer
        # before any channel machinery sees it
        from . import hooks as HK

        if HK.active(self, "peer_connected"):
            hres = await HK.call(self, "peer_connected", {"peer": {
                "id": node_id.hex(),
                "direction": "in" if incoming else "out",
                "features": their_features.hex()}})
            if hres.get("result") == "disconnect":
                await stream.send_msg(M.Error(
                    channel_id=b"\x00" * 32,
                    data=str(hres.get("error_message",
                                      "rejected by plugin")).encode(),
                ).serialize())
                raise _InitError("peer rejected by plugin")
        peer = Peer(self, stream, node_id, their_features, incoming)
        self.peers[node_id] = peer
        peer.start_pump()
        log.info("peer %s %s", node_id.hex()[:16],
                 "connected in" if incoming else "connected out")
        from ..utils import events

        events.emit("connect", {"id": node_id.hex(),
                                "direction": "in" if incoming else "out"})
        if self.on_peer is not None and incoming:
            task = asyncio.get_running_loop().create_task(self.on_peer(peer))
            self._peer_tasks.add(task)
            task.add_done_callback(self._peer_task_done)
        return peer

    async def _read_init(self, stream: NoiseStream) -> M.Init:
        """BOLT#1: `init` must be the first message; tolerate nothing else
        (peer_exchange_initmsg.c rejects non-init first messages)."""
        raw = await stream.read_msg()
        t = codec.msg_type(raw)
        if t != M.Init.TYPE:
            raise _InitError(f"first message was type {t}, not init")
        return M.Init.parse(raw)

    # -- lifecycle --------------------------------------------------------

    def _peer_task_done(self, task: asyncio.Task) -> None:
        self._peer_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("peer service task failed", exc_info=task.exception())

    def _peer_gone(self, peer: Peer) -> None:
        if self.peers.get(peer.node_id) is peer:
            del self.peers[peer.node_id]
            from ..utils import events

            events.emit("disconnect", {"id": peer.node_id.hex()})
            if self.on_peer_gone is not None and not self.closing:
                task = asyncio.get_running_loop().create_task(
                    self.on_peer_gone(peer))
                self._peer_tasks.add(task)
                task.add_done_callback(self._peer_task_done)

    async def close(self) -> None:
        self.closing = True   # suppress reconnect storms during shutdown
        # stop accepting first, then drop peers: 3.12's Server.wait_closed
        # blocks until every accepted transport is gone
        if self._server is not None:
            self._server.close()
        for peer in list(self.peers.values()):
            await peer.disconnect()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except asyncio.TimeoutError:
                pass


class _InitError(Exception):
    pass
