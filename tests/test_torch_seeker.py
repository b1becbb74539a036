"""The port's seeker (gossipd/seeker.c parity), the scenarios of
tests/test_seeker.py on the port with an injected clock and rng: a blank
node converges with no manual sync, peers rotate, probes back off while
the view is current, a big gap escalates to a full sync, and stale
channels are pruned.  device="cpu": the plain versions of K1-K3 verify,
seconds a flush here, so the flush windows batch a sync into few
flushes."""
from __future__ import annotations

import asyncio
import random

import torch

from lightning_tpu_torch.daemon.node import LightningNode
from lightning_tpu_torch.gossip import gossipd as GD
from lightning_tpu_torch.gossip import seeker as SK
from lightning_tpu_torch.gossip import store as gstore
from tests.test_gossipd import SCID_A, SCID_B, seed_store
from tests.test_ingest import K1, K2, make_ca

torch.set_num_threads(1)

FLUSH_MS = 150.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 180))


async def _wait(cond, timeout=60.0):
    for _ in range(int(timeout / 0.05)):
        if cond():
            return True
        await asyncio.sleep(0.05)
    return cond()


def _gossipd(node, path, seed=None):
    g = GD.Gossipd(node, path, flush_ms=FLUSH_MS, device="cpu")
    if seed is not None:
        g.load_existing(seed)
    return g


def test_blank_node_converges_autonomously(tmp_path):
    """A and B hold the seeded view; C starts blank, connects to both,
    and its Seeker pulls the whole view with no manual calls."""

    async def body():
        na, nb, nc = (LightningNode(privkey=k)
                      for k in (0xA111, 0xB222, 0xC333))
        seed = str(tmp_path / "seed.gs")
        seed_store(seed)
        ga = _gossipd(na, str(tmp_path / "a.gs"), seed)
        gb = _gossipd(nb, str(tmp_path / "b.gs"), seed)
        gc = _gossipd(nc, str(tmp_path / "c.gs"))
        for g in (ga, gb, gc):
            g.start()
        sk = SK.Seeker(gc, interval=0.2, rng=random.Random(7),
                       clock=lambda: 200.0)   # seed timestamps ~100
        try:
            await nc.connect("127.0.0.1", await na.listen(), na.node_id)
            await nc.connect("127.0.0.1", await nb.listen(), nb.node_id)
            sk.start()
            assert await _wait(
                lambda: set(gc.ingest.channels) == {SCID_A, SCID_B}), \
                f"C never converged: {set(gc.ingest.channels)}"
            assert sk.stats["full_syncs"] >= 1
            assert await _wait(lambda: sk.stats["probes"] >= 2, timeout=30)
            assert sk.backoff > 1        # nothing new: backing off
            assert sk._rotation >= 2     # both peers consulted
        finally:
            await sk.close()
            for x in (ga, gb, gc, na, nb, nc):
                await x.close()

    run(body())


def test_probe_gap_escalates_to_full_sync(tmp_path):
    """Channels appearing on the serving node after the first sync are
    found by a probe; a large batch of unknown scids flips the seeker
    back to a full sync, which delivers them."""

    async def body():
        na, nc = LightningNode(privkey=0xA444), LightningNode(privkey=0xC555)
        seed = str(tmp_path / "seed.gs")
        seed_store(seed)
        ga = _gossipd(na, str(tmp_path / "a.gs"), seed)
        gc = _gossipd(nc, str(tmp_path / "c.gs"))
        ga.start()
        gc.start()
        sk = SK.Seeker(gc, interval=0.2, rng=random.Random(3),
                       clock=lambda: 200.0)
        try:
            await nc.connect("127.0.0.1", await na.listen(), na.node_id)
            await sk.tick()              # the startup full sync
            assert await _wait(
                lambda: set(gc.ingest.channels) == {SCID_A, SCID_B})
            assert sk.state == "probing"

            new_scids = [(549_500 + i % 32) << 40 | (100 + i) << 16
                         for i in range(SK.FULL_SYNC_THRESHOLD)]
            for s in new_scids:
                ga.ingest.channels[s] = (None, None)
                ga.msgs.setdefault(s, {})["ca"] = make_ca(K1, K2, s)

            class _Pin:   # the probe window over the new cluster
                def randrange(self, lo, hi):
                    return 549_000

            sk.rng = _Pin()
            await sk.tick()
            assert sk.state == "startup", "probe did not escalate"
            await sk.tick()              # the escalated full sync
            assert await _wait(
                lambda: set(new_scids) <= set(gc.ingest.channels))
        finally:
            await sk.close()
            for x in (ga, gc, na, nc):
                await x.close()

    run(body())


def test_prune_stale_channels(tmp_path):
    async def body():
        n = LightningNode(privkey=0xD666)
        path = str(tmp_path / "d.gs")
        g = GD.Gossipd(n, path, device="cpu")
        now = 1_700_000_000.0
        sk = SK.Seeker(g, clock=lambda: now)
        g.ingest.writer.append_many([make_ca(K1, K2, SCID_B)], [1], sync=True)
        g.ingest.channels[SCID_A] = (None, None)
        g.ingest.updates[(SCID_A, 0)] = int(now - 100)
        g.ingest.channels[SCID_B] = (None, None)
        g.ingest.updates[(SCID_B, 0)] = int(now - SK.PRUNE_AGE - 10)
        scid_c = 7 << 40
        g.ingest.channels[scid_c] = (None, None)

        assert sk.prune_stale() == 1
        assert SCID_A in g.ingest.channels
        assert SCID_B not in g.ingest.channels      # stale: gone
        assert scid_c in g.ingest.channels          # no update: kept
        assert (SCID_B, 0) not in g.ingest.updates
        await asyncio.sleep(0)
        for t in list(getattr(sk, "_flag_tasks", ())):
            await t
        idx = gstore.load_store(path)               # flagged deleted
        assert not idx.alive().any()
        await g.close()
        await n.close()

    run(body())
