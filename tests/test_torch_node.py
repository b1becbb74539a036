"""The port's node runtime: TCP + BOLT #8 Noise + BOLT #1 init and ping
over loopback, the unknown-message rules, SOCKS5 dialing, and a port node
talking to a JAX package node in both directions.

The scenarios of tests/test_node.py and tests/test_tor.py, on the port.
The JAX nodes here only run the handshake, init and control messages (no
device program)."""
from __future__ import annotations

import asyncio

import pytest

from lightning_tpu.bolt import noise as JN
from lightning_tpu.daemon import features as jfeat
from lightning_tpu.daemon.node import LightningNode as JaxNode
from lightning_tpu.wire import messages as JM
from lightning_tpu_torch import obs
from lightning_tpu_torch.bolt import noise as TN
from lightning_tpu_torch.daemon import features as feat
from lightning_tpu_torch.daemon import tor as TOR
from lightning_tpu_torch.daemon import transport
from lightning_tpu_torch.daemon.node import LightningNode
from lightning_tpu_torch.utils import events
from lightning_tpu_torch.wire import messages as M
from tests.test_tor import MockSocks5


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def _until(cond, steps=200, dt=0.01):
    for _ in range(steps):
        if cond():
            return True
        await asyncio.sleep(dt)
    return cond()


async def _pair(features_a=None, features_b=None):
    a = LightningNode(privkey=0x1111, features=features_a)
    b = LightningNode(privkey=0x2222, features=features_b)
    port = await a.listen()
    peer_ab = await b.connect("127.0.0.1", port, a.node_id)
    await _until(lambda: b.node_id in a.peers, 100)
    return a, b, peer_ab


def _samples(name: str) -> dict:
    fam = obs.snapshot()["metrics"].get(name, {"samples": []})
    return {tuple(sorted(x["labels"].items())): x["value"]
            for x in fam["samples"]}


def test_connect_init_ping_and_peer_metrics():
    async def body():
        bytes0 = sum(_samples("clntpu_peer_bytes_total").values())
        a, b, peer = await _pair()
        try:
            assert b.node_id in a.peers and a.node_id in b.peers
            ours = feat.from_bits(feat.DEFAULT_FEATURES)
            assert peer.remote_features == ours
            assert a.peers[b.node_id].remote_features == ours
            assert feat.has_feature(peer.remote_features,
                                    feat.STATIC_REMOTEKEY)
            assert await peer.ping(num_pong_bytes=7) == 7
            assert await a.peers[b.node_id].ping(num_pong_bytes=3) == 3
            # num_pong_bytes >= 65532 gets no reply (BOLT #1)
            with pytest.raises(asyncio.TimeoutError):
                await peer.ping(num_pong_bytes=65532, timeout=0.5)
            msgs = _samples("clntpu_peer_msgs_total")
            tag = a.node_id.hex()[:16]
            # b sent two pings and a pong, and took a pong and a ping
            assert msgs[(("direction", "out"), ("peer", tag))] == 3
            assert msgs[(("direction", "in"), ("peer", tag))] == 2
            assert sum(_samples("clntpu_peer_bytes_total").values()) > bytes0
        finally:
            await a.close()
            await b.close()

    run(body())


def test_incompatible_features_rejected():
    async def body():
        weird = feat.combine(feat.from_bits(feat.DEFAULT_FEATURES),
                             feat.from_bits([100]))
        a = LightningNode(privkey=0x1111)
        b = LightningNode(privkey=0x2222, features=weird)
        port = await a.listen()
        peer = await b.connect("127.0.0.1", port, a.node_id)
        assert await _until(lambda: not peer.connected)
        assert b.node_id not in a.peers
        await a.close()
        await b.close()

    run(body())


def test_unknown_even_message_disconnects():
    async def body():
        a, b, peer = await _pair()
        try:
            await peer.stream.send_msg((64000).to_bytes(2, "big") + b"junk")
            assert await _until(lambda: not peer.connected)
        finally:
            await a.close()
            await b.close()

    run(body())


def test_unknown_odd_message_is_a_custommsg_event():
    async def body():
        seen = []

        def on_event(topic, payload):
            if topic == "custommsg":
                seen.append(payload)

        events.subscribe_all(on_event)
        a, b, peer = await _pair()
        try:
            await peer.stream.send_msg((64001).to_bytes(2, "big") + b"junk")
            assert await peer.ping(num_pong_bytes=5) == 5   # survives
            assert seen == [{"peer_id": b.node_id.hex(),
                             "payload": ((64001).to_bytes(2, "big")
                                         + b"junk").hex()}]
        finally:
            events.unsubscribe_all(on_event)
            await a.close()
            await b.close()

    run(body())


def test_non_control_message_reaches_inbox_and_handlers():
    async def body():
        a, b, peer = await _pair()
        seen = []

        async def on_shutdown(p, msg):
            seen.append((p.node_id, msg.channel_id))

        try:
            await peer.send(M.Shutdown(
                channel_id=b"\x07" * 32,
                scriptpubkey=b"\x00\x14" + b"\xaa" * 20))
            got = await a.peers[b.node_id].recv(M.Shutdown, timeout=5)
            assert got.channel_id == b"\x07" * 32
            a.register(M.Shutdown, on_shutdown)
            await peer.send(M.Shutdown(
                channel_id=b"\x09" * 32,
                scriptpubkey=b"\x00\x14" + b"\xbb" * 20))
            assert await _until(lambda: seen)
            assert seen == [(b.node_id, b"\x09" * 32)]
        finally:
            await a.close()
            await b.close()

    run(body())


def test_raw_handler_goes_first():
    async def body():
        a, b, peer = await _pair()
        raws = []

        async def on_raw(p, raw):
            raws.append(raw)

        a.raw_handlers[M.Shutdown.TYPE] = on_raw
        try:
            msg = M.Shutdown(channel_id=b"\x05" * 32, scriptpubkey=b"\x51")
            await peer.send(msg)
            assert await _until(lambda: raws)
            assert raws == [msg.serialize()]
            assert a.peers[b.node_id].inbox.empty()
        finally:
            await a.close()
            await b.close()

    run(body())


def test_send_raw_many_is_send_raw_of_each_in_one_write():
    """The batched send puts the same frames on the wire, in order: the
    receiver decrypts each message, and the nonces stay in step for the
    messages after."""
    async def body():
        a, b, peer = await _pair()
        raws = []

        async def on_raw(p, raw):
            raws.append(raw)

        a.raw_handlers[M.Shutdown.TYPE] = on_raw
        msgs = [M.Shutdown(channel_id=bytes([i]) * 32,
                           scriptpubkey=b"\x51" * i).serialize()
                for i in range(5)]
        tag = a.node_id.hex()[:16]
        out0 = _samples("clntpu_peer_msgs_total")[
            (("direction", "out"), ("peer", tag))]
        try:
            writes = []
            write = peer.stream.writer.write
            peer.stream.writer.write = lambda d: (writes.append(d),
                                                  write(d))[1]
            await peer.send_raw_many(msgs[:3])
            await peer.send_raw_many([])
            await peer.send_raw(msgs[3])
            await peer.send_raw_many(msgs[4:])
            assert len(writes) == 3
            assert await _until(lambda: len(raws) == 5)
            assert raws == msgs
            assert await peer.ping(num_pong_bytes=3) == 3
            assert _samples("clntpu_peer_msgs_total")[
                (("direction", "out"), ("peer", tag))] == out0 + 6
        finally:
            await a.close()
            await b.close()

    run(body())


def test_reconnect_replaces_old_peer():
    async def body():
        a, b, peer1 = await _pair()
        try:
            old = a.peers[b.node_id]
            port = a._server.sockets[0].getsockname()[1]
            peer2 = await b.connect("127.0.0.1", port, a.node_id)
            assert await peer2.ping(num_pong_bytes=2) == 2
            assert await _until(lambda: a.peers.get(b.node_id) is not old)
            assert not old.connected
        finally:
            await a.close()
            await b.close()

    run(body())


def test_feature_bits_match_the_jax_package():
    f = feat.from_bits([0, 5, 13])
    assert f == jfeat.from_bits([0, 5, 13])
    assert feat.all_bits(f) == [0, 5, 13]
    assert feat.has_feature(f, 12)
    assert feat.unsupported_features(feat.from_bits([13]), f) == [0]
    assert feat.unsupported_features(f, feat.from_bits([101])) == []
    assert feat.combine(b"\x01", b"\x02\x00") == b"\x02\x01"
    assert feat.from_bits(feat.DEFAULT_FEATURES) == \
        jfeat.from_bits(jfeat.DEFAULT_FEATURES)


def test_ping_timeout_does_not_eat_next_pong():
    async def body():
        a, b, peer = await _pair()
        try:
            with pytest.raises(asyncio.TimeoutError):
                await peer.ping(num_pong_bytes=65532, timeout=0.3)
            assert await peer.ping(num_pong_bytes=4, timeout=5) == 4
        finally:
            await a.close()
            await b.close()

    run(body())


def test_post_handshake_garbage_handled():
    async def body():
        a = LightningNode(privkey=0x1111)
        port = await a.listen()
        stream = await transport.connect_noise(
            "127.0.0.1", port, transport.random_keypair(), a.node_id)
        stream.writer.write(b"\x00" * 18)   # not a valid AEAD frame
        await stream.writer.drain()
        await asyncio.sleep(0.3)
        assert not a.peers
        c = LightningNode(privkey=0x3333)
        peer = await c.connect("127.0.0.1", port, a.node_id)
        assert await peer.ping(num_pong_bytes=2) == 2
        await a.close()
        await c.close()

    run(body())


def test_injected_ephemeral_gives_the_jax_package_act_one():
    """connect_noise(ephemeral=) sends exactly the JAX package's act one
    for the same static and ephemeral keys."""
    async def body():
        got = asyncio.get_running_loop().create_future()

        async def grab(reader, writer):
            got.set_result(await reader.readexactly(TN.ACT_ONE_SIZE))
            writer.close()

        srv = await asyncio.start_server(grab, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        rs, ls, e = 0x2121, 0x1111, 0x1212
        with pytest.raises((asyncio.IncompleteReadError, ConnectionError)):
            await transport.connect_noise(
                "127.0.0.1", port, TN.Keypair(ls),
                TN.Keypair(rs).pub_bytes, ephemeral=TN.Keypair(e))
        act1 = await got
        srv.close()
        want, _ = JN.initiator_handshake(JN.Keypair(ls), JN.Keypair(e),
                                         JN.Keypair(rs).pub)
        assert act1 == want

    run(body())


@pytest.mark.parametrize("listener", ["jax", "port"])
def test_interoperates_with_a_jax_package_node(listener):
    """Handshake, init, ping/pong both ways and a message into each
    inbox, with a JAX package node on one side and a port node on the
    other."""
    async def body():
        jnode, tnode = JaxNode(privkey=0x4444), LightningNode(privkey=0x5555)
        lnode, dnode = (jnode, tnode) if listener == "jax" else (tnode, jnode)
        try:
            port = await lnode.listen()
            peer_d = await dnode.connect("127.0.0.1", port, lnode.node_id)
            assert await _until(lambda: dnode.node_id in lnode.peers)
            peer_l = lnode.peers[dnode.node_id]
            assert peer_d.remote_features == peer_l.remote_features == \
                feat.from_bits(feat.DEFAULT_FEATURES)
            assert await peer_d.ping(num_pong_bytes=9) == 9
            assert await peer_l.ping(num_pong_bytes=1000) == 1000
            mods = {id(jnode): JM, id(tnode): M}
            for src, dst in ((peer_d, peer_l), (peer_l, peer_d)):
                cid = bytes([len(dst.node_id)]) * 32
                await src.send(mods[id(src.node)].Stfu(channel_id=cid,
                                                       initiator=1))
                got = await dst.recv(mods[id(dst.node)].Stfu, timeout=5)
                assert (got.channel_id, got.initiator) == (cid, 1)
        finally:
            await jnode.close()
            await tnode.close()

    run(body())


def test_noise_handshake_through_socks5():
    async def body():
        na = LightningNode(privkey=0xA77)
        nb = LightningNode(privkey=0xB88)
        port = await na.listen()
        proxy = MockSocks5()
        pport = await proxy.start()
        nb.tor_proxy = ("127.0.0.1", pport)
        try:
            peer = await nb.connect("127.0.0.1", port, na.node_id)
            assert await peer.ping(num_pong_bytes=16) == 16
            assert proxy.requests == [("127.0.0.1", port)]
        finally:
            proxy.server.close()
            await na.close()
            await nb.close()

    run(body())


def test_socks5_auth_and_denial():
    async def body():
        srv = await asyncio.start_server(lambda r, w: w.close(),
                                         "127.0.0.1", 0)
        tport = srv.sockets[0].getsockname()[1]
        authp = MockSocks5(require_auth=True)
        ap = await authp.start()
        _, w = await TOR.socks5_connect("127.0.0.1", ap, "127.0.0.1", tport,
                                        username="u", password="p")
        w.close()
        with pytest.raises(TOR.TorError):
            await TOR.socks5_connect("127.0.0.1", ap, "127.0.0.1", tport)
        denier = MockSocks5(deny=True)
        dp = await denier.start()
        with pytest.raises(TOR.TorError, match="refused"):
            await TOR.socks5_connect("127.0.0.1", dp, "example.onion", 9735)
        assert denier.requests == [("example.onion", 9735)]
        for s in (srv, authp.server, denier.server):
            s.close()

    run(body())


def test_onion_requires_proxy():
    async def body():
        n = LightningNode(privkey=0xC99)
        with pytest.raises(ConnectionError, match="tor proxy"):
            await n.connect("abcdef.onion", 9735, b"\x02" + b"\x11" * 32)
        await n.close()

    run(body())
