"""Bridge between the daemon's live paths and a plugin host.

The reference registers hooks at fixed call sites with
REGISTER_PLUGIN_HOOK (lightningd/plugin_hook.h:118) and resolves
subscribers through the single lightningd instance.  Here the anchor is
the LightningNode: daemon assembly sets ``node.plugin_host``, and
protocol code resolves the host through whatever node-reachable object
it holds (a Peer, the node itself).  With no host attached (tests,
library use, and the port as it stands, which has no plugin host) every
hook resolves to ``{"result": "continue"}`` at zero cost, and two nodes
in one process never see each other's plugins.

The port's own copy of the JAX package's daemon/hooks.py.
"""
from __future__ import annotations

import logging

log = logging.getLogger("lightning_tpu_torch.hooks")

HOOK_CONTINUE = {"result": "continue"}


def host_for(anchor):
    """Resolve the plugin host from a node-reachable anchor (a Peer has
    .node; a LightningNode carries .plugin_host directly)."""
    node = getattr(anchor, "node", anchor)
    return getattr(node, "plugin_host", None)


def active(anchor, name: str) -> bool:
    """True when some plugin subscribes to this hook: lets hot paths
    skip payload construction entirely (plugin_hook.c does the same via
    the hook's subscriber list)."""
    host = host_for(anchor)
    return host is not None and bool(host.hooks.get(name))


async def call(anchor, name: str, payload: dict) -> dict:
    """Chained-hook call; {"result": "continue"} when unsubscribed."""
    host = host_for(anchor)
    if host is None or not host.hooks.get(name):
        return HOOK_CONTINUE
    try:
        return await host.call_hook(name, payload)
    except Exception:
        # a broken plugin must not take the channel down with it
        log.exception("hook %s failed; continuing", name)
        return HOOK_CONTINUE
