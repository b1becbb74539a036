"""The port's gossipd against the JAX package's: BOLT #7 queries, sync and
live fan-out between real nodes over TCP + Noise.

The scenarios of tests/test_gossipd.py on the port (device="cpu": the
plain versions of K1-K3 verify; each flush costs seconds here, so the
flush windows are wide enough to batch a sync into few flushes); the
query replies of a port Gossipd and a JAX package Gossipd loaded from one
seeded store (verify=False: no device program of the JAX package runs)
are byte-identical; a blank port node syncs from a JAX package node.
"""
from __future__ import annotations

import asyncio

import pytest
import torch

from lightning_tpu.daemon.node import LightningNode as JaxNode
from lightning_tpu.gossip import gossipd as JGD
from lightning_tpu.resilience import overload as JOV
from lightning_tpu_torch.daemon.node import LightningNode
from lightning_tpu_torch.gossip import gossipd as GD
from lightning_tpu_torch.gossip import store as gstore
from lightning_tpu_torch.gossip import verify as TV
from lightning_tpu_torch.gossip import wire as gwire
from lightning_tpu_torch.resilience import overload as TOV
from lightning_tpu_torch.wire import messages as M
from tests.test_gossipd import SCID_A, SCID_B, seed_store
from tests.test_ingest import K1, K2, K3, make_ca, make_cu, make_na, pub

torch.set_num_threads(1)

FLUSH_MS = 150.0   # a sync's burst lands in one flush


@pytest.fixture(autouse=True)
def _fresh_overload():
    """Overload controllers and the shed ring are process-global: leave
    none of this file's (some shed on purpose) to later tests."""
    yield
    JOV.reset_for_tests()
    TOV.reset_for_tests()


def run(coro, limit=120):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def _wait(cond, timeout=60.0):
    for _ in range(int(timeout / 0.02)):
        if cond():
            return True
        await asyncio.sleep(0.02)
    return cond()


def test_scid_codec_matches_the_jax_package():
    scids = [SCID_A, SCID_B, 42]
    assert GD.encode_scids(scids) == JGD.encode_scids(scids)
    assert GD.decode_scids(GD.encode_scids(scids)) == sorted(scids)
    with pytest.raises(ValueError):
        GD.decode_scids(b"\x01\x00")
    with pytest.raises(ValueError):
        GD.decode_scids(b"\x00\x01")
    assert GD.decode_scids(b"") == []


def test_load_existing_and_verify(tmp_path):
    async def body():
        src = str(tmp_path / "seed.gs")
        seed_store(src)
        node = LightningNode(privkey=0x9101)
        gd = GD.Gossipd(node, str(tmp_path / "live.gs"), device="cpu")
        assert gd.load_existing(src, verify=True) == 6
        assert set(gd.ingest.channels) == {SCID_A, SCID_B}
        assert pub(K2) in gd.node_msgs
        await gd.close()

    run(body())


def test_device_and_knobs_reach_the_ingest_and_replay(tmp_path, monkeypatch):
    src = str(tmp_path / "seed.gs")
    seed_store(src)
    gd = GD.Gossipd(LightningNode(privkey=0x9102), str(tmp_path / "k.gs"),
                    device="cpu", deadline_s=0.5, high_wm=8192)
    ing = gd.ingest
    assert (ing.device.type, ing.deadline_s) == ("cpu", 0.5)
    assert (ing.overload.high_wm, ing.overload.low_wm,
            ing.pending_cap) == (8192, 4096, 8192)
    seen = []
    real = TV.verify_store

    def spy(idx, *a, **kw):
        seen.append(kw.get("device"))
        return real(idx, *a, **kw)

    monkeypatch.setattr(TV, "verify_store", spy)
    assert gd.load_existing(src, verify=True) == 6
    assert [d.type for d in seen] == ["cpu"]
    ing.writer.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GD.Gossipd(LightningNode(privkey=0x9103), str(tmp_path / "c.gs"))


def test_seeker_sync_and_live_fanout(tmp_path):
    async def body():
        na, nb = LightningNode(privkey=0xA111), LightningNode(privkey=0xB222)
        seed = str(tmp_path / "seed.gs")
        seed_store(seed)
        ga = GD.Gossipd(na, str(tmp_path / "a.gs"), flush_ms=FLUSH_MS,
                        device="cpu")
        ga.load_existing(seed)
        gb = GD.Gossipd(nb, str(tmp_path / "b.gs"), flush_ms=FLUSH_MS,
                        device="cpu")
        ga.start()
        gb.start()
        try:
            port = await na.listen()
            peer_ba = await nb.connect("127.0.0.1", port, na.node_id)
            assert await gb.sync_with(peer_ba, timeout=60) == 2
            assert await _wait(lambda: (
                len(gb.ingest.channels) == 2 and gb.node_msgs
                and gb.ingest.updates.get((SCID_A, 0)) == 100
                and (SCID_B, 0) in gb.ingest.updates))
            assert pub(K2) in gb.node_msgs
            await gb.ingest.drain()
            assert len(gstore.load_store(str(tmp_path / "b.gs"))) == 6

            # live fan-out under B's timestamp filter
            await ga.ingest.submit(make_cu(K1, K2, SCID_A, 0, ts=200))
            assert await _wait(
                lambda: gb.ingest.updates.get((SCID_A, 0)) == 200)
        finally:
            for x in (ga, gb, na, nb):
                await x.close()

    run(body())


def test_query_range_block_filter(tmp_path):
    async def body():
        na, nb = LightningNode(privkey=0xA333), LightningNode(privkey=0xB444)
        seed = str(tmp_path / "seed.gs")
        seed_store(seed)
        ga = GD.Gossipd(na, str(tmp_path / "a.gs"), device="cpu")
        ga.load_existing(seed)
        try:
            port = await na.listen()
            peer = await nb.connect("127.0.0.1", port, na.node_id)
            await peer.send(M.QueryChannelRange(
                chain_hash=gwire.MAINNET_CHAIN_HASH,
                first_blocknum=500_000, number_of_blocks=1))
            reply = await peer.recv(M.ReplyChannelRange, timeout=10)
            assert GD.decode_scids(reply.encoded_short_ids) == [SCID_A]
            assert reply.sync_complete == 1
        finally:
            await ga.close()
            await na.close()
            await nb.close()

    run(body())


def _richer_store(path: str) -> None:
    """The seeded store plus a third channel, a second update of A, an
    update outside a filter window and two more node announcements."""
    msgs = seed_store(path)
    scid_c = (600_000 << 40) | (7 << 16) | 1
    w = gstore.StoreWriter(path)
    for m in (make_ca(K1, K3, scid_c), make_cu(K1, K3, scid_c, 1, ts=500),
              make_cu(K1, K2, SCID_A, 0, ts=300), make_na(K1, ts=250),
              make_na(K3, ts=90)):
        w.append(m, timestamp=100)
    w.close()
    assert len(msgs) == 6


async def _replies(node_cls, gd_cls, store: str, tmp, privkey: int,
                   queries) -> list[list[bytes]]:
    """Serve `store` from a node of one package; a port client sends each
    query and records every raw message the server sends back, up to a
    pong that follows the query."""
    server = node_cls(privkey=privkey)
    gd = gd_cls(server, str(tmp / f"serve_{privkey:x}.gs"),
                **({"device": "cpu"} if gd_cls is GD.Gossipd else {}))
    gd.load_existing(store)
    client = LightningNode(privkey=0xC0FE)
    got: list[bytes] = []

    async def keep(peer, raw):
        got.append(raw)

    for t in (256, 257, 258, M.ReplyChannelRange.TYPE,
              M.ReplyShortChannelIdsEnd.TYPE):
        client.raw_handlers[t] = keep
    out = []
    try:
        port = await server.listen()
        peer = await client.connect("127.0.0.1", port, server.node_id)
        for q in queries:
            got.clear()
            await peer.send(q)
            await peer.ping(num_pong_bytes=1)   # after the whole reply
            out.append(list(got))
    finally:
        await client.close()
        await server.close()
        gd.ingest.writer.close()
    return out


def test_query_replies_match_the_jax_package(tmp_path):
    store = str(tmp_path / "rich.gs")
    _richer_store(store)
    ch = gwire.MAINNET_CHAIN_HASH
    scid_c = (600_000 << 40) | (7 << 16) | 1
    queries = [
        M.QueryChannelRange(chain_hash=ch, first_blocknum=0,
                            number_of_blocks=0xFFFFFFFF),
        M.QueryChannelRange(chain_hash=ch, first_blocknum=600_000,
                            number_of_blocks=1),
        M.QueryChannelRange(chain_hash=ch, first_blocknum=1,
                            number_of_blocks=5),
        M.QueryShortChannelIds(chain_hash=ch, encoded_short_ids=(
            GD.encode_scids([SCID_B, scid_c, 12345]))),
        M.QueryShortChannelIds(chain_hash=ch,
                               encoded_short_ids=GD.encode_scids([SCID_A])),
        M.QueryShortChannelIds(chain_hash=ch, encoded_short_ids=b"\x01ab"),
        M.GossipTimestampFilter(chain_hash=ch, first_timestamp=101,
                                timestamp_range=200),
        M.GossipTimestampFilter(chain_hash=ch, first_timestamp=0,
                                timestamp_range=0xFFFFFFFF),
    ]

    async def body():
        port = await _replies(LightningNode, GD.Gossipd, store, tmp_path,
                              0xA555, queries)
        jax = await _replies(JaxNode, JGD.Gossipd, store, tmp_path, 0xA555,
                             queries)
        return port, jax

    port, jax = run(body())
    assert port == jax
    assert [len(r) for r in port] == [1, 1, 1, 8, 6, 1, 8, 10]


def test_blank_port_node_syncs_from_a_jax_node(tmp_path):
    """A JAX package node serves the store; a blank port node verifies
    and accepts all of it.  Only the port verifies: the JAX node never
    receives gossip, so its ingest never flushes."""
    async def body():
        store = str(tmp_path / "rich.gs")
        _richer_store(store)
        ja, nb = JaxNode(privkey=0xA666), LightningNode(privkey=0xB666)
        ga = JGD.Gossipd(ja, str(tmp_path / "ja.gs"))
        ga.load_existing(store)
        gb = GD.Gossipd(nb, str(tmp_path / "b.gs"), flush_ms=FLUSH_MS,
                        device="cpu")
        ga.start()
        gb.start()
        try:
            port = await ja.listen()
            peer = await nb.connect("127.0.0.1", port, ja.node_id)
            assert await gb.sync_with(peer, timeout=60) == 3
            want = (set(ga.ingest.channels), dict(ga.ingest.updates),
                    dict(ga.ingest.nodes))
            assert await _wait(lambda: (
                set(gb.ingest.channels), gb.ingest.updates,
                gb.ingest.nodes) == want)
            await gb.ingest.drain()
            assert gb.msgs == ga.msgs and gb.node_msgs == ga.node_msgs
            assert ga.ingest.stats.flushes == 0
        finally:
            for x in (ga, gb, ja, nb):
                await x.close()

    run(body())


class _Peer:
    """Stands in for a Peer: records what a gossipd sends it."""

    def __init__(self, node_id: bytes = b"\x02" * 33):
        self.node_id = node_id
        self.connected = True
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)

    async def send_raw(self, raw):
        self.sent.append(raw)

    async def send_raw_many(self, raws):
        self.sent.extend(raws)


def _blocks(msg) -> set:
    return {GD.scid_block(s) for s in GD.decode_scids(msg.encoded_short_ids)}


@pytest.mark.parametrize("per_block", [3000, 9000],
                         ids=["whole_blocks", "a_block_past_the_cap"])
def test_range_reply_splits_past_max_scids(tmp_path, per_block):
    """Past MAX_SCIDS the reply is split: every reply encodes (its
    encoded_short_ids fits the u16 length), the replies' ranges follow
    each other over the query's, and together hold every scid."""
    gd = GD.Gossipd(LightningNode(privkey=0x9201), str(tmp_path / "r.gs"),
                    device="cpu")
    scids = [(700_000 + i // per_block) << 40 | (i % per_block) << 16
             for i in range(20_000)]
    for s in scids:
        gd.ingest.channels[s] = (None, None)
    peer = _Peer()
    run(gd._on_query_range(peer, M.QueryChannelRange(
        chain_hash=gwire.MAINNET_CHAIN_HASH, first_blocknum=699_990,
        number_of_blocks=100)))
    replies = peer.sent
    assert len(replies) == (3 if per_block == 3000 else 4)
    assert replies[0].first_blocknum == 699_990
    for a, b in zip(replies, replies[1:]):
        assert b.first_blocknum == a.first_blocknum + a.number_of_blocks
    assert replies[-1].first_blocknum + replies[-1].number_of_blocks == \
        700_090
    got = [GD.decode_scids(r.encoded_short_ids) for r in replies]
    assert all(len(g) <= GD.MAX_SCIDS for g in got)
    assert sum(got, []) == sorted(scids)
    if per_block == 3000:         # cut at block boundaries only
        assert all(not (_blocks(a) & _blocks(b))
                   for a, b in zip(replies, replies[1:]))
    for r in replies:
        assert len(r.serialize()) < 65_600
    gd.ingest.writer.close()


def test_sync_joins_split_replies_and_splits_its_queries(tmp_path):
    async def body():
        gd = GD.Gossipd(LightningNode(privkey=0x9202),
                        str(tmp_path / "q.gs"), device="cpu")
        peer = _Peer()
        ch = gwire.MAINNET_CHAIN_HASH
        task = asyncio.create_task(gd.sync_with(
            peer, first_blocknum=0, number_of_blocks=1000, timeout=10))
        await asyncio.sleep(0.01)
        assert [type(m) for m in peer.sent] == [M.GossipTimestampFilter,
                                                M.QueryChannelRange]
        peer.sent.clear()
        scids = [(10 + i // 2000) << 40 | (i % 2000) << 16
                 for i in range(17_000)]
        known = scids[:5]
        for s in known:
            gd.ingest.channels[s] = (None, None)
        parts = GD.range_chunks(scids, 0, 1000)
        assert len(parts) == 3
        for first, n_blocks, part in parts:
            assert peer.sent == []  # no query before the range's last reply
            await gd._on_reply_range(peer, M.ReplyChannelRange(
                chain_hash=ch, first_blocknum=first, number_of_blocks=n_blocks,
                sync_complete=1, encoded_short_ids=GD.encode_scids(part)))
        asked = []
        while not task.done():
            assert len(peer.sent) == 1, "one query in flight at a time"
            q = peer.sent.pop()
            asked.append(GD.decode_scids(q.encoded_short_ids))
            await gd._on_scids_end(peer, M.ReplyShortChannelIdsEnd(
                chain_hash=ch, full_information=1))
            await asyncio.sleep(0.01)
        assert [len(a) for a in asked] == [8000, 8000, 16_995 - 16_000]
        assert sum(asked, []) == scids[5:]
        assert await task == 16_995
        gd.ingest.writer.close()

    run(body())


def test_shed_gossip_is_asked_for_again(tmp_path):
    """The channels of shed updates and of shed node announcements (by a
    channel of the node) join the next range reply's query, once."""
    async def body():
        gd = GD.Gossipd(LightningNode(privkey=0x9203),
                        str(tmp_path / "s.gs"), device="cpu")
        ing = gd.ingest
        ing.channels[SCID_A] = (pub(K1), pub(K2))
        ing.channels[SCID_B] = (pub(K2), pub(K3))
        cu = gwire.parse_gossip(make_cu(K1, K2, SCID_B, 0, ts=5))
        na = gwire.parse_gossip(make_na(K1, ts=7))
        lone = gwire.parse_gossip(make_na(0x4242, ts=7))
        for kind, p in ((gwire.MSG_CHANNEL_UPDATE, cu),
                        (gwire.MSG_NODE_ANNOUNCEMENT, na),
                        (gwire.MSG_NODE_ANNOUNCEMENT, lone)):
            ing._shed(1, "queue_full", kind, p, b"peer")
        peer = _Peer()
        ch = gwire.MAINNET_CHAIN_HASH
        reply = M.ReplyChannelRange(
            chain_hash=ch, first_blocknum=0, number_of_blocks=1,
            sync_complete=1, encoded_short_ids=GD.encode_scids([SCID_A]))
        await gd._on_reply_range(peer, reply)
        assert GD.decode_scids(peer.sent[-1].encoded_short_ids) == \
            sorted([SCID_A, SCID_B])
        assert gd._shed_nodes == {pub(0x4242)}   # no channel yet
        peer.sent.clear()
        evt = gd._synced[peer.node_id] = asyncio.Event()
        await gd._on_reply_range(peer, reply)     # nothing shed since
        assert peer.sent == [] and evt.is_set()
        ing.writer.close()

    run(body())


def test_ingest_hands_every_shed_to_on_shed(tmp_path):
    """Both of the ingest's shed sites (queue admission, the pending
    cap) call on_shed with the message's kind, parsed form and source,
    besides counting it."""
    from lightning_tpu_torch.gossip import ingest as TI

    async def body():
        seen = []
        ing = TI.GossipIngest(str(tmp_path / "shed.gs"), device="cpu",
                              high_wm=1, low_wm=1, pending_cap=0,
                              on_shed=lambda *a: seen.append(a))
        await ing.submit(make_ca(K1, K2, SCID_A), source=b"peer-a")
        await ing.submit(make_cu(K1, K2, SCID_B, 0, ts=9), source=b"peer-b")
        assert [(k, s) for k, _, s in seen] == [
            (gwire.MSG_CHANNEL_ANNOUNCEMENT, b"peer-a"),
            (gwire.MSG_CHANNEL_UPDATE, b"peer-b")]
        assert seen[1][1].short_channel_id == SCID_B
        assert ing.stats.dropped == {TI.R_SHED: 2}
        assert ing.overload.shed_counts == {("fresh", "queue_full"): 1,
                                            ("fresh", "pending_cap"): 1}
        ing.writer.close()

    run(body())
