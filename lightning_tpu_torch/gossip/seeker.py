"""Autonomous gossip seeker: keep the network view current with no
operator action.

Parity target: gossipd/seeker.c:28-100 — a periodic state machine that
(1) full-syncs from a peer when starting up or provably far behind,
(2) otherwise probes random scid ranges against rotating peers to find
gaps, escalating to a full sync when a probe uncovers too many unknown
channels, (3) backs off exponentially while the view stays current, and
(4) prunes channels whose newest channel_update went stale (the
reference's 2-week prune, gossipd.c).

The wire work is delegated to Gossipd.sync_with (timestamp filter +
query_channel_range + query_short_channel_ids); the seeker only decides
WHEN, from WHOM, and WHAT RANGE.  The port's own copy of the JAX
package's gossip/seeker.py; its rng and clock are injectable.
"""
from __future__ import annotations

import asyncio
import logging
import random
import time

log = logging.getLogger("lightning_tpu_torch.seeker")

# seeker.c cadence: startup sync immediately, then probe every minute,
# backing off ×2 (cap 8×) while nothing new turns up
PROBE_INTERVAL = 60.0
BACKOFF_CAP = 8
# a probe that uncovers this many unknown scids means we are behind
FULL_SYNC_THRESHOLD = 16
PROBE_BLOCKS = 2016          # one retarget period per gap probe
PRUNE_AGE = 14 * 24 * 3600   # BOLT#7 stale-channel prune


class Seeker:
    def __init__(self, gossipd, interval: float = PROBE_INTERVAL,
                 rng: random.Random | None = None,
                 clock=time.time):
        self.g = gossipd
        self.interval = interval
        self.rng = rng or random.Random()
        self.clock = clock
        self.state = "startup"
        self.backoff = 1
        self._rotation = 0
        self._task: asyncio.Task | None = None
        self.stats = {"ticks": 0, "full_syncs": 0, "probes": 0,
                      "found": 0, "pruned": 0}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("seeker tick failed; continuing")
            await asyncio.sleep(self.interval * self.backoff)

    # -- the state machine ------------------------------------------------

    def _pick_peer(self):
        """Rotate through connected peers (seeker.c peer rotation: never
        keep asking the same peer, its view may be stale/partial)."""
        peers = [p for p in self.g.node.peers.values()
                 if getattr(p, "connected", False)]
        if not peers:
            return None
        peer = peers[self._rotation % len(peers)]
        self._rotation += 1
        return peer

    def _known_block_span(self) -> tuple[int, int]:
        scids = self.g.ingest.channels
        if not scids:
            return (0, 0)
        blocks = [s >> 40 for s in scids]
        return (min(blocks), max(blocks))

    async def tick(self) -> None:
        """One seeker step; factored out so tests drive it directly
        instead of sleeping through the cadence."""
        self.stats["ticks"] += 1
        peer = self._pick_peer()
        if peer is None:
            return
        if self.state == "startup":
            found = await self._full_sync(peer)
            self.state = "probing"
            self.backoff = 1 if found else 2
        else:
            found = await self._probe(peer)
            if found >= FULL_SYNC_THRESHOLD:
                # the gap was not an isolated miss: we are behind
                self.state = "startup"
                self.backoff = 1
            elif found:
                self.backoff = 1
            else:
                self.backoff = min(self.backoff * 2, BACKOFF_CAP)
        self.prune_stale()

    async def _ingested_delta(self, do_sync) -> int:
        """Run a sync and count channels that actually SURVIVED
        verification+ingest — sync_with's return is merely the number
        REQUESTED, which a peer advertising bogus scids could inflate
        forever (it would pin backoff at 1 and force a full sync every
        tick)."""
        before = len(self.g.ingest.channels)
        await do_sync()
        await self.g.ingest.drain()
        return max(0, len(self.g.ingest.channels) - before)

    async def _full_sync(self, peer) -> int:
        self.stats["full_syncs"] += 1
        try:
            n = await self._ingested_delta(
                lambda: self.g.sync_with(peer, timeout=30.0))
        except (asyncio.TimeoutError, ConnectionError) as e:
            log.info("full sync from %s failed: %s",
                     peer.node_id.hex()[:16], e)
            return 0
        self.stats["found"] += n
        log.info("seeker: full sync from %s found %d new channel(s)",
                 peer.node_id.hex()[:16], n)
        return n

    async def _probe(self, peer) -> int:
        """Ask one peer about a random block window and fetch unknown
        scids (seeker.c probe_some_random_scids role)."""
        self.stats["probes"] += 1
        lo, hi = self._known_block_span()
        span_end = max(hi + PROBE_BLOCKS, lo + PROBE_BLOCKS)
        first = self.rng.randrange(lo, span_end + 1) if span_end > lo \
            else lo
        try:
            n = await self._ingested_delta(
                lambda: self.g.sync_with(peer, first_blocknum=first,
                                         number_of_blocks=PROBE_BLOCKS,
                                         timeout=15.0))
        except (asyncio.TimeoutError, ConnectionError) as e:
            log.info("probe of %s failed: %s", peer.node_id.hex()[:16], e)
            return 0
        self.stats["found"] += n
        return n

    def prune_stale(self, now: float | None = None) -> int:
        """Drop channels whose NEWEST update is older than PRUNE_AGE
        (gossipd gossip_time-based prune).  Channels with no update at
        all are kept — their announcement may simply predate our first
        update sighting."""
        now = now if now is not None else self.clock()
        cutoff = now - PRUNE_AGE
        ing = self.g.ingest
        stale = []
        for scid in list(ing.channels):
            stamps = [ing.updates[k] for k in
                      ((scid, 0), (scid, 1)) if k in ing.updates]
            if stamps and max(stamps) < cutoff:
                stale.append(scid)
        for scid in stale:
            ing.channels.pop(scid, None)
            ing.updates.pop((scid, 0), None)
            ing.updates.pop((scid, 1), None)
            self.g.msgs.pop(scid, None)
        if stale:
            # durable: flip FLAG_DELETED in the store so a restart's
            # load_existing does not resurrect them, and compaction can
            # reclaim the bytes.  The flagging scans the WHOLE store
            # (mmap + per-record parse) — at the 1M-record scale that
            # is seconds of work, so it runs off the event loop.
            from . import store as gstore

            def _flag(path=ing.writer.path, scids=set(stale)):
                try:
                    gstore.mark_deleted(path, scids)
                except Exception:
                    log.exception("store prune flagging failed")

            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                _flag()               # sync caller (tests)
            else:
                t = loop.create_task(asyncio.to_thread(_flag))
                self._flag_tasks = getattr(self, "_flag_tasks", set())
                self._flag_tasks.add(t)
                t.add_done_callback(self._flag_tasks.discard)
            self.stats["pruned"] += len(stale)
            log.info("seeker: pruned %d stale channel(s)", len(stale))
        return len(stale)
