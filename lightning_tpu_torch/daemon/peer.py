"""Per-peer message pump and BOLT#1 control handling.

Functional parity targets: connectd's per-peer muxing
(connectd/multiplex.c:1562 read loop), BOLT#1 ping/pong (the reference
handles these in connectd so lightningd never sees them), and the
"it's OK to be odd" unknown-message rule (BOLT#1; common/wire_error).
The port's own copy of the JAX package's daemon/peer.py.
"""
from __future__ import annotations

import asyncio
import logging
import time

from .. import obs
from ..bolt import noise
from ..wire import codec
from ..wire import messages as M
from .transport import NoiseStream

log = logging.getLogger("lightning_tpu_torch.peer")

_M_MSGS = obs.counter(
    "clntpu_peer_msgs_total",
    "Lightning wire messages, by direction and peer",
    labelnames=("direction", "peer"), max_label_sets=256)

ZERO_CHANNEL_ID = b"\x00" * 32
MAX_PONG_REPLY = 65532  # BOLT#1: >= this means "don't reply"


class PeerError(Exception):
    pass


class _PeerGone:
    """Inbox sentinel: the transport died under a blocked recv."""


class Peer:
    """One connected, init-exchanged peer."""

    def __init__(self, node, stream: NoiseStream, node_id: bytes,
                 remote_features: bytes, incoming: bool):
        self.node = node
        self.stream = stream
        self.node_id = node_id
        self.remote_features = remote_features
        self.incoming = incoming
        # short prefix keeps the exposition readable; collisions only
        # merge two peers' counters, never misroute traffic
        self._obs_peer = node_id.hex()[:16]
        stream.obs_peer = self._obs_peer
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.connected = True
        self.connected_at = time.monotonic()
        self._pong_waiters: list[asyncio.Future] = []
        self._pump_task: asyncio.Task | None = None
        # dev fault injection (common/dev_disconnect.h role): kill or
        # blackhole the transport after N more sends.  Tests script the
        # worst-moment disconnects the reference scripts with
        # --dev-disconnect files.
        self._dev_disconnect_after: int | None = None
        self._dev_blackhole = False

    # -- sending ---------------------------------------------------------

    def dev_disconnect(self, after_sends: int, blackhole: bool = False):
        """Drop (or blackhole: swallow writes without closing) the
        transport after `after_sends` more outbound messages."""
        self._dev_disconnect_after = after_sends
        self._dev_blackhole = blackhole

    async def send(self, msg: codec.Message) -> None:
        if self._dev_disconnect_after is not None:
            if self._dev_disconnect_after <= 0:
                if self._dev_blackhole:
                    return            # swallowed: peer never sees it
                await self.disconnect()
                raise ConnectionError("dev_disconnect")
            self._dev_disconnect_after -= 1
        _M_MSGS.labels("out", self._obs_peer).inc()
        await self.stream.send_msg(msg.serialize())

    async def send_error(self, data: bytes, channel_id: bytes = ZERO_CHANNEL_ID):
        try:
            await self.send(M.Error(channel_id=channel_id, data=data))
        except (ConnectionError, OSError):
            pass

    async def ping(self, num_pong_bytes: int = 1, ignored_len: int = 0,
                   timeout: float = 30.0) -> int:
        """Send a ping, await the matching pong; returns the pong's
        ignored-bytes length."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pong_waiters.append(fut)
        try:
            await self.send(M.Ping(num_pong_bytes=num_pong_bytes,
                                   ignored=b"\x00" * ignored_len))
            return await asyncio.wait_for(fut, timeout)
        finally:
            # a timed-out waiter must not swallow the next pong
            if fut in self._pong_waiters:
                self._pong_waiters.remove(fut)

    # -- receiving -------------------------------------------------------

    async def recv(self, *types: type, timeout: float = 30.0) -> codec.Message:
        """Await the next non-control message (optionally of given types).
        Protocol drivers (opening/closing/channel flows) consume this the
        way reference subdaemons consume their peer fd.

        Non-matching WIRE messages are dropped with a warning (lockstep
        dances tolerate this).  Non-matching INTERNAL sentinels (MPP
        settlements, relay offers — anything that isn't a codec.Message)
        are deferred and requeued when this call completes: a commitment
        dance mid-flight must never eat a cross-task settlement, or the
        upstream HTLC of a forward would silently never be claimed."""
        deferred: list = []
        try:
            while True:
                msg = await asyncio.wait_for(self.inbox.get(), timeout)
                if isinstance(msg, _PeerGone):
                    # transport died: wake the consumer instead of letting
                    # it sit out the full protocol timeout on a dead link.
                    # Requeue the sentinel so EVERY later recv on this dead
                    # peer fails fast too (disconnect is sticky).
                    self.inbox.put_nowait(msg)
                    raise ConnectionError("peer disconnected")
                if not types or isinstance(msg, types):
                    return msg
                if not isinstance(msg, codec.Message):
                    deferred.append(msg)
                    continue
                log.warning("%s: ignoring unexpected %s while waiting for %s",
                            self.node_id.hex()[:8], type(msg).__name__,
                            [t.__name__ for t in types])
        finally:
            for m in deferred:
                self.inbox.put_nowait(m)

    def start_pump(self) -> None:
        self._pump_task = asyncio.get_running_loop().create_task(self._pump())

    async def _pump(self) -> None:
        try:
            while True:
                raw = await self.stream.read_msg()
                await self._handle_raw(raw)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except noise.HandshakeError as e:
            log.warning("%s: transport failure: %s", self.node_id.hex()[:8], e)
        except Exception:
            log.exception("%s: peer pump failed", self.node_id.hex()[:8])
        finally:
            await self._disconnected()

    async def send_raw(self, raw: bytes) -> None:
        """Forward pre-serialized bytes (gossip fan-out path: connectd
        streams store records without re-encoding)."""
        _M_MSGS.labels("out", self._obs_peer).inc()
        await self.stream.send_msg(raw)

    async def send_raw_many(self, raws: list[bytes]) -> None:
        """send_raw of each, in order, in one transport write."""
        if raws:
            _M_MSGS.labels("out", self._obs_peer).inc(len(raws))
            await self.stream.send_msgs(raws)

    async def _handle_raw(self, raw: bytes) -> None:
        _M_MSGS.labels("in", self._obs_peer).inc()
        try:
            t = codec.msg_type(raw)
        except codec.WireError:
            return  # runt frame; BOLT#1 says ignore
        raw_handler = self.node.raw_handlers.get(t)
        if raw_handler is not None:
            await raw_handler(self, raw)
            return
        cls = codec.MessageMeta.registry.get(t)
        if cls is None:
            if t % 2 == 0:
                # unknown EVEN type: must fail the connection (BOLT#1)
                await self.send_error(
                    f"unknown message type {t}".encode()
                )
                await self.disconnect()
                return
            # unknown odd: custommsg hook + notification
            # (lightningd custommsg_hook; sendcustommsg counterpart)
            from . import hooks as HKP

            if HKP.active(self, "custommsg"):
                await HKP.call(self, "custommsg", {
                    "peer_id": self.node_id.hex(),
                    "payload": raw.hex()})
            from ..utils import events as _ev

            _ev.emit("custommsg", {"peer_id": self.node_id.hex(),
                                   "payload": raw.hex()})
            return
        try:
            msg = cls.parse(raw)
        except codec.WireError as e:
            await self.send_error(f"bad {cls.__name__}: {e}".encode())
            await self.disconnect()
            return

        if isinstance(msg, M.Ping):
            if msg.num_pong_bytes < MAX_PONG_REPLY:
                await self.send(M.Pong(ignored=b"\x00" * msg.num_pong_bytes))
            return
        if isinstance(msg, M.Pong):
            if self._pong_waiters:
                fut = self._pong_waiters.pop(0)
                if not fut.done():
                    fut.set_result(len(msg.ignored))
            return
        if isinstance(msg, M.Error):
            log.warning("%s: peer error: %r", self.node_id.hex()[:8],
                        msg.data[:128])
            await self.disconnect()
            return
        if isinstance(msg, M.Warning_):
            log.warning("%s: peer warning: %r", self.node_id.hex()[:8],
                        msg.data[:128])
            return

        handler = self.node.handlers.get(type(msg))
        if handler is not None:
            await handler(self, msg)
        else:
            await self.inbox.put(msg)

    # -- lifecycle -------------------------------------------------------

    async def disconnect(self) -> None:
        self.connected = False
        await self.stream.close()

    async def _disconnected(self) -> None:
        self.connected = False
        for fut in self._pong_waiters:
            if not fut.done():
                fut.set_exception(ConnectionError("peer disconnected"))
        self._pong_waiters.clear()
        self.inbox.put_nowait(_PeerGone())  # wake any blocked recv
        self.node._peer_gone(self)

    async def wait_closed(self) -> None:
        if self._pump_task is not None:
            await asyncio.shield(self._pump_task)
