"""Carry state from the JAX package's arrays into the port's tensors.

The port learns nothing from data; what both packages must share is limb
data, the constant window tables (the verify scans' and the sign path's
comb), a scanned store, the routing graph and askrene's layers.  The JAX
package holds them as numpy arrays: field elements as uint32 (..., 20)
radix-2^13 limbs, which become int64 tensors here (same values, the
port's dtype).
The caller passes the arrays in; this module imports nothing of the JAX
package, so it works on any numpy arrays of those layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from .crypto.field import NLIMBS
from .gossip.gossmap import Gossmap
from .gossip.store import StoreIndex
from .gossip.verify import VerifyItems
from .routing.mcf import Layers

_INDEX_FIELDS = ("offsets", "lengths", "flags", "timestamps", "crcs", "types")
_GOSSMAP_ARRAYS = ("node_ids", "scids", "node1", "node2", "capacity_sat",
                   "enabled", "cltv_delta", "htlc_min_msat", "htlc_max_msat",
                   "fee_base_msat", "fee_ppm", "timestamps", "adj_off",
                   "adj_chan", "adj_dir", "adj_src")
_ITEM_FIELDS = ("rows", "n_blocks", "sigs", "pubkeys", "msg_index", "z_host",
                "row_of_item")


def limbs(arr, device="cpu") -> torch.Tensor:
    """uint32 (..., 20) radix-2^13 limbs -> int64 tensor of the same
    values (window tables, field elements, scalars)."""
    a = np.asarray(arr)
    if a.shape[-1] != NLIMBS:
        raise ValueError(f"expected (..., {NLIMBS}) limbs, got {a.shape}")
    return torch.as_tensor(a.astype(np.int64), device=device)


def comb_table(arr, device="cpu") -> torch.Tensor:
    """The JAX package's comb table (``_comb_table()``: (64, 16, 2, 20)
    uint32 limbs, entry [j][v] the affine v * 2^(4j) * G, v = 0 unused)
    -> the port's, ``secp256k1._comb_table()`` as an int64 tensor."""
    a = np.asarray(arr)
    if a.shape != (64, 16, 2, NLIMBS):
        raise ValueError(f"expected a (64, 16, 2, {NLIMBS}) comb table, "
                         f"got {a.shape}")
    return limbs(a, device)


def store_index(idx) -> StoreIndex:
    """A scanned store (anything with StoreIndex's fields) -> the port's
    StoreIndex over the same buffer."""
    return StoreIndex(np.asarray(idx.buf, np.uint8),
                      **{k: np.asarray(getattr(idx, k)) for k in _INDEX_FIELDS})


def verify_items(items) -> VerifyItems:
    """An extracted signature workload -> the port's VerifyItems (the
    store-region fields stay unset)."""
    return VerifyItems(**{k: None if getattr(items, k) is None
                          else np.asarray(getattr(items, k))
                          for k in _ITEM_FIELDS})


def gossmap(g) -> Gossmap:
    """A routing graph (anything with Gossmap's fields) -> the port's
    Gossmap: copies of its arrays, its version counters, its dirty flag
    and its parameter log."""
    return Gossmap(
        **{k: None if getattr(g, k) is None else np.array(getattr(g, k))
           for k in _GOSSMAP_ARRAYS},
        topology_version=int(g.topology_version),
        params_version=int(g.params_version),
        _adjacency_dirty=bool(g._adjacency_dirty),
        _param_log=[(int(c), int(d)) for c, d in g._param_log],
        _param_log_base=int(g._param_log_base))


def mcf_layers(layers) -> Layers:
    """askrene's layer state (anything with mcf.Layers' fields) -> the
    port's mcf.Layers: copies of its containers (knowledge's, created's
    and updates' inner dicts too)."""
    return Layers(
        disabled=set(layers.disabled),
        biases=dict(layers.biases),
        reserved=dict(layers.reserved),
        knowledge={k: dict(v) for k, v in layers.knowledge.items()},
        created={k: dict(v) for k, v in layers.created.items()},
        updates={k: dict(v) for k, v in layers.updates.items()},
        disabled_nodes=set(layers.disabled_nodes),
        node_biases=dict(layers.node_biases))
