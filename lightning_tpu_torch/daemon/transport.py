"""asyncio transport: TCP + BOLT#8 Noise_XK handshake + AEAD framing.

Functional parity targets: connectd/connectd.c:648 (`connection_in`) /
:793 (`connection_out`) for the dial/accept roles, and the read/write
pump of connectd/multiplex.c:1214/1562, re-shaped as one asyncio stream
class instead of the reference's callback-chained ccan/io plan machinery
(the host IO plane is Python asyncio; the compute plane is the card, see
gossip/ingest.py and daemon/hsmd.py).  The port's own copy of the JAX
package's daemon/transport.py.
"""
from __future__ import annotations

import asyncio
import os

from .. import obs
from ..bolt import noise
from ..crypto import ref_python as ref

HANDSHAKE_TIMEOUT = 30.0

# wire-level accounting: encrypted frame bytes per direction per peer
# (the label is set by Peer once the node_id is known; pre-init traffic
# books under the handshake placeholder).  Label cardinality is capped
# by the registry, so a churning peer set folds into `<other>`.
_M_BYTES = obs.counter(
    "clntpu_peer_bytes_total",
    "Encrypted transport bytes, by direction and peer",
    labelnames=("direction", "peer"), max_label_sets=256)


def random_keypair() -> noise.Keypair:
    return noise.Keypair(int.from_bytes(os.urandom(32), "big") % (ref.N - 1) + 1)


class NoiseStream:
    """An established BOLT#8 transport over an asyncio TCP stream."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, cm: noise.CryptoMsg):
        self.reader = reader
        self.writer = writer
        self.cm = cm
        self.obs_peer = "handshake"   # Peer overwrites with the node_id

    @property
    def remote_pub_bytes(self) -> bytes:
        return ref.pubkey_serialize(self.cm.remote_pub)

    async def read_msg(self) -> bytes:
        hdr = await self.reader.readexactly(18)
        ln = self.cm.decrypt_length(hdr)
        body = await self.reader.readexactly(ln + 16)
        _M_BYTES.labels("in", self.obs_peer).inc(18 + ln + 16)
        return self.cm.decrypt_body(body)

    async def send_msg(self, msg: bytes) -> None:
        frame = self.cm.encrypt(msg)
        _M_BYTES.labels("out", self.obs_peer).inc(len(frame))
        self.writer.write(frame)
        await self.writer.drain()

    async def send_msgs(self, msgs: list[bytes]) -> None:
        """Several messages in one write: the same frames, in the same
        order, as send_msg one at a time, in one syscall (a bulk stream
        of small messages otherwise costs a socket write each)."""
        frames = b"".join(self.cm.encrypt(m) for m in msgs)
        _M_BYTES.labels("out", self.obs_peer).inc(len(frames))
        self.writer.write(frames)
        await self.writer.drain()

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def connect_noise(host: str, port: int, local: noise.Keypair,
                        remote_pub: bytes,
                        ephemeral: noise.Keypair | None = None,
                        open_conn=None) -> NoiseStream:
    """Dial a peer and run the initiator side of the 3-act handshake
    (connectd/connectd.c:793 connection_out).  open_conn: alternative
    async (host, port) -> (reader, writer) dialer — the SOCKS5/tor path
    (connectd/tor.c) plugs in here."""
    if open_conn is not None:
        reader, writer = await open_conn(host, port)
    else:
        reader, writer = await asyncio.open_connection(host, port)
    try:
        e = ephemeral or random_keypair()
        act1, on_act2 = noise.initiator_handshake(
            local, e, ref.pubkey_parse(remote_pub)
        )
        writer.write(act1)
        await writer.drain()
        act2 = await asyncio.wait_for(
            reader.readexactly(noise.ACT_TWO_SIZE), HANDSHAKE_TIMEOUT
        )
        act3, keys = on_act2(act2)
        writer.write(act3)
        await writer.drain()
        return NoiseStream(reader, writer, noise.CryptoMsg(keys))
    except BaseException:
        writer.close()
        raise


async def accept_noise(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter, local: noise.Keypair,
                       ephemeral: noise.Keypair | None = None) -> NoiseStream:
    """Run the responder side of the handshake on an accepted connection
    (connectd/connectd.c:648 connection_in)."""
    try:
        e = ephemeral or random_keypair()
        on_act1 = noise.responder_handshake(local, e)
        act1 = await asyncio.wait_for(
            reader.readexactly(noise.ACT_ONE_SIZE), HANDSHAKE_TIMEOUT
        )
        act2, on_act3 = on_act1(act1)
        writer.write(act2)
        await writer.drain()
        act3 = await asyncio.wait_for(
            reader.readexactly(noise.ACT_THREE_SIZE), HANDSHAKE_TIMEOUT
        )
        keys = on_act3(act3)
        return NoiseStream(reader, writer, noise.CryptoMsg(keys))
    except BaseException:
        writer.close()
        raise
