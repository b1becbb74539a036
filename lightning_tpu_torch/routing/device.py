"""Device-batched pathfinding: a batched backward Bellman-Ford sweep over
RoutePlanes on the card (kernel R1, routing/csrc/route_sweep.cu), plus
the micro-batching RouteService front-end.

The host dijkstra (routing/dijkstra.py) solves one query at a time with
a heapq; here Q concurrent queries become one kernel launch.

Sweep: ``max_hops`` Jacobi relaxation sweeps.  Each sweep reads the
previous sweep's (cost, amount, delay) labels at every edge's RECEIVING
node, prices the edge with dijkstra's exact integer cost model
(compounding msat fees + CLN risk cost), and folds candidates per
FORWARDING node with two minimums (cost, then lowest edge index among
cost ties).  After k sweeps a node's label is the cheapest <= k-hop path
to the destination, dijkstra's settled label whenever the hop cap does
not bind (LN paths are ~5 hops against a cap of 20).

Tie-break rule: among equal-cost candidate edges for a node within one
sweep, the LOWEST edge index in the destination-keyed CSR wins; an
existing label is only replaced by a STRICTLY cheaper one.  Total cost
does not depend on it; the chosen hops may differ from dijkstra's when
distinct paths price identically.

Exactness: all msat math is int64.  Per-edge overflow guards bound every
product below 2^61; a query whose relaxation would pass them raises an
overflow flag and is answered by the host (Python ints).  Every
returned route re-validates on the host with exact ints (hop cap, HTLC
windows, total cost against the kernel's label) and goes to the host on
any mismatch, so a device "ok" is always a valid route priced by
dijkstra's exact cost model.  When the 20-hop cap BINDS, dijkstra's hop
limit is a search prune while the sweep solves the <= 20-edge problem
exactly: the device can then return a valid route where the host
reports NoRoute.

Host answers are part of the exactness contract and nothing else: a
query the sweep cannot express (amount or riskfactor past its cap, a
max_hops other than the sweep count) or whose answer could not be
proven (overflow, reconstruction mismatch) is answered by dijkstra, and
counted by reason in ``RouteService.stats``.  Every flush of the
service goes to the card, however few queries it holds.  A dispatch that
raises fails its flush's queries with the error; nothing is re-solved on
the host for it.
"""
from __future__ import annotations

import asyncio
import collections
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from ..resilience import deadline as _deadline
from ..resilience import overload as _overload
from ..utils import events
from . import dijkstra as DJ
from . import hopper_route as HR
from .dijkstra import NoRoute, RouteHop
from .planes import RoutePlanes

log = logging.getLogger("lightning_tpu_torch.routing.device")

DEFAULT_MAX_HOPS = 20
# label sentinel: far above any real path cost, far below int64 overflow
# even after adding one more edge's fee+risk
INF_COST = HR.INF_COST

ROUTE_BATCH = 64            # device query bucket
ROUTE_FLUSH_MS = 2.0        # flush latency budget
ROUTE_MAX_AMOUNT_MSAT = 1 << 48
# admission-control high watermark, in queued QUERIES (the low one is
# half of it): past it getroute rejects retryably (Overloaded with a
# retry-after hint) instead of queueing without bound
ROUTE_HIGH_WM = 256
# riskfactor joins cd (<= 2^16) in an int64 product INSIDE the overflow
# guard itself: a huge rf would wrap cd * rf and disarm the guard, so
# larger values go to the host's Python ints
ROUTE_MAX_RISKFACTOR = 1_000_000
# flush durations kept for the percentiles in stats
_FLUSH_HISTORY = 4096

# host-answer reasons
R_AMOUNT_CAP = "amount_cap"
R_RISKFACTOR_CAP = "riskfactor_cap"
R_MAX_HOPS = "max_hops"
R_OVERFLOW = "overflow"
R_RECONSTRUCT = "reconstruct"

_PLANE_ORDER = ("edge_src", "edge_dst", "edge_base", "edge_ppm",
                "edge_cltv", "edge_hmin", "edge_hmax")
# parameter planes a channel_update can change (patched on the device);
# src/dst are topology and only ever upload whole
_PARAM_PLANES = ("edge_base", "edge_ppm", "edge_cltv", "edge_hmin",
                 "edge_hmax")


def _device_plane_args(planes: RoutePlanes) -> tuple:
    """Upload (once per planes revision) and return the planes on
    ``planes.device``, with R1's in-edge offsets beside them in
    ``planes.dev["in_off"]``.  A param-refresh revision arrives with the
    topology uploads carried over, so only the missing planes copy; an
    incremental revision (``patch_idx`` set by with_patched_params)
    scatters JUST the touched lanes.  The scatter is ``index_copy``,
    out of place, as the JAX package's ``.at[].set``: the predecessor
    revision's tensors stay as they were for a solve still reading
    them."""
    dev = planes.device
    patch = planes.patch_idx
    if patch is not None and len(patch):
        idx = torch.as_tensor(patch, device=dev)
        for name in _PARAM_PLANES:
            if name in planes.dev:
                vals = torch.as_tensor(getattr(planes, name)[patch],
                                       device=dev)
                planes.dev[name] = planes.dev[name].index_copy(0, idx, vals)
    planes.patch_idx = None
    for name in (*_PLANE_ORDER, "in_off"):
        if name not in planes.dev:
            planes.dev[name] = torch.as_tensor(getattr(planes, name),
                                               device=dev)
    return tuple(planes.dev[n] for n in _PLANE_ORDER)


# ---------------------------------------------------------------------------
# Batched solve + host-exact route reconstruction


@dataclass
class RouteQuery:
    """One getroute request (same semantics as dijkstra.getroute)."""

    source: bytes
    destination: bytes
    amount_msat: int
    final_cltv: int = 18
    riskfactor: int = DJ.DEFAULT_RISKFACTOR
    max_hops: int = DEFAULT_MAX_HOPS
    excluded_scids: set | None = None
    # (solve_batch always returns the payer-side (amount, delay) pair;
    # getroute's with_source only shapes ITS return value)
    future: object = None


def _reconstruct(planes: RoutePlanes, via: np.ndarray, src: int, dst: int,
                 amount_msat: int, final_cltv: int, riskfactor: int,
                 dist_src: int, max_hops: int):
    """Walk the predecessor edges src -> dst, then price the path
    backward with exact Python ints: the amounts and delays are
    bit-identical to what dijkstra.py labels along the same hops.

    The walk RE-VALIDATES what the kernel checked against its in-sweep
    labels: a Jacobi label can survive pointing at a downstream chain
    that a later sweep rewrote, so the final chain may be longer than
    the sweep count, carry amounts outside an edge's HTLC window, or
    price differently than dist[src].  Any mismatch raises, and the
    caller sends the query to the host solver."""
    g = planes.g
    edges = []
    u = src
    while u != dst:
        e = int(via[u])
        # >= : dijkstra's hop cap is a hard contract
        if e < 0 or len(edges) >= max_hops:
            raise RuntimeError("predecessor walk diverged")
        edges.append(e)
        u = int(planes.edge_dst[e])
    amount, delay = amount_msat, final_cltv
    cost = 0
    amounts: list[tuple[int, int]] = []   # (amount, delay) at edge's dst
    for e in reversed(edges):
        amounts.append((amount, delay))
        if amount < int(planes.edge_hmin[e]):
            raise RuntimeError("reconstructed amount under htlc_min")
        hmax = int(planes.edge_hmax[e])
        if hmax and amount > hmax:
            raise RuntimeError("reconstructed amount over htlc_max")
        fee = DJ.hop_fee_msat(int(planes.edge_base[e]),
                              int(planes.edge_ppm[e]), amount)
        cost += fee + DJ._risk_msat(amount, int(planes.edge_cltv[e]),
                                    riskfactor)
        amount += fee
        delay += int(planes.edge_cltv[e])
    if cost != dist_src:
        raise RuntimeError("reconstructed cost disagrees with label")
    amounts.reverse()
    route = [
        RouteHop(
            node_id=bytes(g.node_ids[int(planes.edge_dst[e])]),
            scid=int(g.scids[int(planes.edge_chan[e])]),
            direction=int(planes.edge_dir[e]),
            amount_msat=amt, delay=dly,
        )
        for e, (amt, dly) in zip(edges, amounts)
    ]
    return route, (amount, delay)


def solve_batch(planes: RoutePlanes, queries: list[RouteQuery],
                batch: int = ROUTE_BATCH) -> list[tuple]:
    """Solve every query in ceil(Q / batch) sweeps on ``planes.device``
    (R1 on the card, its plain version on the CPU).

    Returns one tuple per query:
      ("ok", route, (src_amount, src_delay))  reachable, exact
      ("noroute", message)                    provably unreachable
      ("fallback", reason)                    the host answers instead
      ("error", exc)                          the query's own error
    """
    g = planes.g
    dev = planes.device
    out: list[tuple] = [None] * len(queries)
    idx_cache: dict[bytes, int] = {}

    def node_idx(nid: bytes) -> int:
        i = idx_cache.get(nid)
        if i is None:
            i = idx_cache[nid] = g.node_index(nid)
        return i

    plane_args = _device_plane_args(planes)
    for start in range(0, len(queries), batch):
        chunk = queries[start:start + batch]
        ok_mat = np.zeros((batch, planes.e_pad), bool)
        src = np.zeros(batch, np.int32)
        dst = np.zeros(batch, np.int32)
        amount = np.ones(batch, np.int64)
        cltv = np.zeros(batch, np.int64)
        rf = np.ones(batch, np.int64)
        for i, q in enumerate(chunk):
            try:
                src[i] = node_idx(q.source)
                dst[i] = node_idx(q.destination)
            except KeyError as e:
                # unknown node: this query's error, not the batch's; its
                # lanes stay masked-off padding
                out[start + i] = ("error", e)
                continue
            if src[i] == dst[i]:
                # dijkstra raises NoRoute here; a dst-initialized label
                # would otherwise read as a zero-cost empty route
                out[start + i] = ("noroute", "source is destination")
                continue
            # values outside [0, cap] would wrap the sweep's own int64
            # guard products, and the sweep count is fixed for the
            # batch, so a per-query hop cap cannot be honoured
            if not 0 <= q.amount_msat <= ROUTE_MAX_AMOUNT_MSAT:
                out[start + i] = ("fallback", R_AMOUNT_CAP)
                continue
            if not 0 <= q.riskfactor <= ROUTE_MAX_RISKFACTOR:
                out[start + i] = ("fallback", R_RISKFACTOR_CAP)
                continue
            if q.max_hops != DEFAULT_MAX_HOPS:
                out[start + i] = ("fallback", R_MAX_HOPS)
                continue
            amount[i] = q.amount_msat
            cltv[i] = q.final_cltv
            rf[i] = q.riskfactor
            ok_mat[i] = planes.edge_ok_mask(q.excluded_scids)
        lanes = (ok_mat, src, dst, amount, cltv, rf)
        dist_src, via, ovf = (t.cpu().numpy() for t in HR.route_sweep(
            *plane_args, *(torch.as_tensor(a, device=dev) for a in lanes),
            planes.n_pad, DEFAULT_MAX_HOPS, in_off=planes.dev["in_off"]))
        for i, q in enumerate(chunk):
            if out[start + i] is not None:
                continue       # resolved above
            if ovf[i]:
                # int64 headroom exceeded somewhere reachable: the host's
                # Python ints own this query (exactness over speed)
                out[start + i] = ("fallback", R_OVERFLOW)
            elif dist_src[i] >= INF_COST:
                out[start + i] = ("noroute", _noroute_msg(q))
            else:
                try:
                    route, src_info = _reconstruct(
                        planes, via[i], int(src[i]), int(dst[i]),
                        q.amount_msat, q.final_cltv, q.riskfactor,
                        int(dist_src[i]), DEFAULT_MAX_HOPS)
                    out[start + i] = ("ok", route, src_info)
                except RuntimeError as e:
                    log.warning("route reconstruction diverged (%s); "
                                "the host answers", e)
                    out[start + i] = ("fallback", R_RECONSTRUCT)
    return out


def _noroute_msg(q: RouteQuery) -> str:
    return DJ.noroute_msg(q.source, q.destination, q.amount_msat)


def route_cost_msat(g, route: list[RouteHop], riskfactor: int) -> int:
    """Total dijkstra-model cost (fees + risk) of a hop list: the parity
    currency between the host and device solvers."""
    cost = 0
    for h in route:
        c = g.channel_index(h.scid)
        d = h.direction
        fee = DJ.hop_fee_msat(int(g.fee_base_msat[d, c]),
                              int(g.fee_ppm[d, c]), h.amount_msat)
        risk = DJ._risk_msat(h.amount_msat, int(g.cltv_delta[d, c]),
                             riskfactor)
        cost += fee + risk
    return cost


# ---------------------------------------------------------------------------
# The micro-batching front-end


@dataclass
class ServiceStats:
    """What a routing service (RouteService, mcf_device.McfService) did:
    queries by (path, outcome), host answers by reason, flushes and
    their seconds, the device's lanes and the queries in them
    (occupancy), and flush-loop restarts."""

    queries: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)
    flushes: int = 0
    flush_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=_FLUSH_HISTORY))
    device_queries: int = 0
    device_lanes: int = 0
    restarts: int = 0

    def count(self, table: dict, key) -> None:
        table[key] = table.get(key, 0) + 1


class FlushService:
    """The micro-batching flush loop the routing services share (the
    gossip ingest's shape): queries queue until the flush window closes
    or a batch is full, then one ``_flush_batch`` answers them all.

    A subclass names its ``FAMILY`` (the overload controller's name and
    the ``<family>_flush_error`` events topic) and its defaults, and
    implements ``_flush_batch``."""

    FAMILY = ""
    FLUSH_MS = 0.0
    BATCH = 0
    HIGH_WM = 0

    def __init__(self, get_map, *, flush_ms: float | None = None,
                 batch: int | None = None, device=None,
                 now=time.monotonic, high_wm: int | None = None):
        self.get_map = get_map          # () -> Gossmap | None
        self.device = D.resolve(device)
        self.flush_ms = self.FLUSH_MS if flush_ms is None else flush_ms
        self.batch = batch or self.BATCH
        high = self.HIGH_WM if high_wm is None else high_wm
        self.overload = _overload.controller(
            self.FAMILY, high, high // 2, breaker_family=self.FAMILY,
            now=now)
        self.now = now
        self.stats = ServiceStats()
        self._planes = None             # the planes of the last dispatch
        self._queue: list = []
        self._inflight = 0               # queries inside a running flush
        self._flush_due: float | None = None
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        self._wakeup.set()
        if self._task is not None:
            await self._task

    # -- submission -------------------------------------------------------

    def _admit(self) -> asyncio.Future:
        """The future of one new query, or a raise: the service is not
        running, or (admission control) past the high watermark the
        query is REJECTED retryably instead of joining an unbounded
        queue."""
        if self._closed or self._task is None or self._task.done():
            raise RuntimeError(f"{self.FAMILY} service not running")
        if not self.overload.admit(_overload.PRIO_QUERY):
            self.overload.shed(_overload.PRIO_QUERY, "admission")
            raise self.overload.overloaded()
        return asyncio.get_running_loop().create_future()

    def _enqueue(self, q) -> None:
        self._queue.append(q)
        self._note_backlog()
        if self._flush_due is None:
            # adaptive flush window: the latency budget stretches as
            # pressure rises (throughput over latency under load)
            self._flush_due = self.now() + self.overload.window_s(
                self.flush_ms)
            self._wakeup.set()
        if len(self._queue) >= self._flush_threshold():
            self._wakeup.set()

    def _flush_threshold(self) -> int:
        """Adaptive size trigger: `batch` when calm, widening under
        pressure so one flush serves more queries."""
        return self.overload.flush_target(self.batch)

    def _note_backlog(self) -> None:
        self.overload.update(len(self._queue), self._inflight)

    # -- the flush loop ---------------------------------------------------

    async def _run(self) -> None:
        """Supervised flush loop: an exception escaping a flush (its
        queries already failed with it) is emitted on the events bus
        (topic ``<family>_flush_error``) and the loop restarts after a
        capped exponential backoff, queued queries intact."""
        topic = f"{self.FAMILY}_flush_error"
        try:
            backoff = _deadline.RestartBackoff()
            while not self._closed:
                try:
                    await self._step()
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self.stats.restarts += 1
                    delay = backoff.next()
                    _deadline.note_restart(f"{self.FAMILY}_flush", e, delay)
                    events.emit(topic, {"error": repr(e),
                                        "restart_delay_s": round(delay, 3)})
                    await asyncio.sleep(delay)
                else:
                    backoff.reset()
            if self._queue:
                try:
                    await self.flush()
                except Exception as e:   # shutting down: surfaced
                    events.emit(topic, {"error": repr(e),
                                        "restart_delay_s": 0.0})
        finally:
            # cancellation teardown: strand no queued caller
            batch, self._queue = self._queue, []
            for q in batch:
                if not q.future.done():
                    q.future.set_exception(
                        RuntimeError(f"{self.FAMILY} service stopped"))

    async def _step(self) -> None:
        """One flush-loop iteration."""
        if self._flush_due is None:
            await self._wakeup.wait()
            self._wakeup.clear()
            return
        timeout = self._flush_due - self.now()
        if timeout > 0 and len(self._queue) < self._flush_threshold():
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wakeup.clear()
            return
        if self._queue:
            await self.flush()

    async def flush(self) -> None:
        """Answer everything queued: one batched dispatch on the card,
        the host answers on the loop.  A dispatch that raises fails this
        flush's queries with its error and propagates."""
        batch, self._queue = self._queue, []
        self._flush_due = None
        self._inflight = len(batch)
        self._note_backlog()
        if not batch:
            self._inflight = 0
            return
        self.stats.flushes += 1
        t0 = time.perf_counter()
        try:
            await self._flush_batch(batch)
        except Exception as e:
            for q in batch:
                if not q.future.done():
                    self.stats.count(self.stats.queries, ("device", "error"))
                    q.future.set_exception(e)
            raise
        finally:
            dt = time.perf_counter() - t0
            self.stats.flush_s.append(dt)
            self._inflight = 0
            self.overload.note_drain(len(batch), dt)
            self._note_backlog()

    def _note_device(self, n: int) -> None:
        """Occupancy: ``n`` queries went to the card in padded batches."""
        self.stats.device_queries += n
        self.stats.device_lanes += -(-n // self.batch) * self.batch

    async def _flush_batch(self, batch: list) -> None:
        raise NotImplementedError


class RouteService(FlushService):
    """Coalesce concurrent getroute queries into batched sweeps on the
    card.

    ``getroute()`` is a drop-in awaitable for dijkstra.getroute: same
    arguments, same return shapes, same NoRoute / KeyError behaviour.
    """

    FAMILY = "route"
    FLUSH_MS = ROUTE_FLUSH_MS
    BATCH = ROUTE_BATCH
    HIGH_WM = ROUTE_HIGH_WM

    async def getroute(self, source: bytes, destination: bytes,
                       amount_msat: int, final_cltv: int = 18,
                       riskfactor: int = DJ.DEFAULT_RISKFACTOR,
                       max_hops: int = DEFAULT_MAX_HOPS,
                       excluded_scids: set | None = None,
                       with_source: bool = False):
        g = self.get_map()
        if g is None:
            raise NoRoute("no gossip graph loaded")
        if source == destination:
            raise NoRoute("source is destination")
        q = RouteQuery(
            source, destination, int(amount_msat), int(final_cltv),
            int(riskfactor), int(max_hops), excluded_scids,
            future=self._admit())
        self._enqueue(q)
        route, src_info = await q.future
        return (route, src_info) if with_source else route

    async def _flush_batch(self, batch: list[RouteQuery]) -> None:
        g = self.get_map()
        if g is None:
            for q in batch:
                self._resolve(q, "host", ("noroute",
                                          "no gossip graph loaded"))
            return
        host: list[tuple[RouteQuery, str]] = []
        device: list[RouteQuery] = []
        for q in batch:
            # [0, cap] screens: NEGATIVE values are as dangerous as
            # oversized ones (they slide under the sweep's a_v > thr
            # overflow test)
            if not 0 <= q.amount_msat <= ROUTE_MAX_AMOUNT_MSAT:
                host.append((q, R_AMOUNT_CAP))
            elif not 0 <= q.riskfactor <= ROUTE_MAX_RISKFACTOR:
                host.append((q, R_RISKFACTOR_CAP))
            elif q.max_hops != DEFAULT_MAX_HOPS:
                host.append((q, R_MAX_HOPS))
            else:
                device.append(q)
        if device:
            self._planes = RoutePlanes.current(g, self._planes, self.device)
            results = await asyncio.to_thread(solve_batch, self._planes,
                                              device, self.batch)
            self._note_device(len(device))
            for q, res in zip(device, results):
                if res[0] == "fallback":
                    host.append((q, res[1]))
                else:
                    self._resolve(q, "device", res)
        # ON the event loop, deliberately: accepted channel_updates
        # mutate the live Gossmap from the loop, and dijkstra reads those
        # arrays live; the device path reads its immutable planes
        for q, reason in host:
            self.stats.count(self.stats.host, reason)
            self._resolve(q, "host", self._host_solve(g, q))
            await asyncio.sleep(0)

    @staticmethod
    def _host_solve(g, q: RouteQuery) -> tuple:
        try:
            route, src_info = DJ.getroute(
                g, q.source, q.destination, q.amount_msat,
                final_cltv=q.final_cltv, riskfactor=q.riskfactor,
                max_hops=q.max_hops, excluded_scids=q.excluded_scids,
                with_source=True)
            return ("ok", route, src_info)
        except NoRoute as e:
            return ("noroute", str(e))
        except Exception as e:
            return ("error", e)

    def _resolve(self, q: RouteQuery, path: str, res: tuple) -> None:
        fut = q.future
        if fut.done():
            return
        outcome = res[0] if res[0] in ("ok", "noroute") else "error"
        self.stats.count(self.stats.queries, (path, outcome))
        if res[0] == "ok":
            fut.set_result((res[1], res[2]))
        elif res[0] == "noroute":
            fut.set_exception(NoRoute(res[1]))
        else:
            err = res[1]
            fut.set_exception(err if isinstance(err, BaseException)
                              else RuntimeError(str(err)))

