"""The port stands alone and never picks the CPU on its own.

Importing lightning_tpu_torch and every module under it must leave jax,
lightning_tpu, lightning_tpu.* and cryptography out of sys.modules; this runs
in a fresh interpreter, because tests/conftest.py imports jax for the whole
session.
Entry points default to the card and raise without one unless the caller
asks for the CPU."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightning_tpu_torch import device as D
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import hopper_secp as H
from lightning_tpu_torch.daemon import hsmd as TH
from lightning_tpu_torch.gossip import ingest as TI
from lightning_tpu_torch.gossip import store as TST
from lightning_tpu_torch.gossip import verify as TV
from lightning_tpu_torch.gossip.gossmap import Gossmap
from lightning_tpu_torch.routing import device as TRD
from lightning_tpu_torch.routing import hopper_route as HR
from lightning_tpu_torch.routing import mcf_device as TMD
from lightning_tpu_torch.routing.planes import RoutePlanes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import lightning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "lightning_tpu" or m.startswith("lightning_tpu.")
             or m == "cryptography" or m.startswith("cryptography."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for mod in ("lightning_tpu_torch.gossip.verify",
                "lightning_tpu_torch.crypto.hopper_secp",
                "lightning_tpu_torch.crypto.engines",
                "lightning_tpu_torch.convert",
                "lightning_tpu_torch.btc.keys",
                "lightning_tpu_torch.btc.script",
                "lightning_tpu_torch.btc.tx",
                "lightning_tpu_torch.channel.commitment",
                "lightning_tpu_torch.daemon.hsmd",
                "lightning_tpu_torch.utils.events",
                "lightning_tpu_torch.resilience.breaker",
                "lightning_tpu_torch.resilience.deadline",
                "lightning_tpu_torch.resilience.overload",
                "lightning_tpu_torch.gossip.gossmap",
                "lightning_tpu_torch.gossip.ingest",
                "lightning_tpu_torch.routing.dijkstra",
                "lightning_tpu_torch.routing.planes",
                "lightning_tpu_torch.routing.hopper_route",
                "lightning_tpu_torch.routing.device",
                "lightning_tpu_torch.routing.mcf",
                "lightning_tpu_torch.routing.mcf_device",
                "lightning_tpu_torch.utils.trace",
                "lightning_tpu_torch.utils.logring",
                "lightning_tpu_torch.obs",
                "lightning_tpu_torch.obs.registry",
                "lightning_tpu_torch.obs.collector",
                "lightning_tpu_torch.obs.families",
                "lightning_tpu_torch.obs.flight",
                "lightning_tpu_torch.obs.journey",
                "lightning_tpu_torch.obs.attribution",
                "lightning_tpu_torch.obs.health",
                "lightning_tpu_torch.obs.traceexport",
                "lightning_tpu_torch.obs.incident",
                "lightning_tpu_torch.resilience.faultinject",
                "lightning_tpu_torch.resilience.quarantine",
                "lightning_tpu_torch.crypto.chachapoly",
                "lightning_tpu_torch.wire.codec",
                "lightning_tpu_torch.wire.messages",
                "lightning_tpu_torch.bolt.noise",
                "lightning_tpu_torch.daemon.features",
                "lightning_tpu_torch.daemon.hooks",
                "lightning_tpu_torch.daemon.transport",
                "lightning_tpu_torch.daemon.tor",
                "lightning_tpu_torch.daemon.peer",
                "lightning_tpu_torch.daemon.node",
                "lightning_tpu_torch.gossip.gossipd",
                "lightning_tpu_torch.gossip.seeker"):
        assert mod in got["modules"]


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve("cuda")
    idx = TST.load_store(str(tmp_path / "missing.gs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.verify_store(idx)
    one = np.zeros((1, 32), np.uint8)
    args = (one, np.zeros((1, 64), np.uint8), np.zeros((1, 33), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.ecdsa_verify_batch(*args)
    assert E.ecdsa_verify_batch(*(a[:0] for a in args),
                                device="cpu").shape == (0,)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.ecdsa_sign_batch(one, [1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.derive_pubkeys(np.ones((1, 20), np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.GossipIngest(str(tmp_path / "ingest.gs"))
    TI.GossipIngest(str(tmp_path / "ingest.gs"), device="cpu").writer.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.schnorr_verify_batch(one, args[1], one)
    hsm = TH.Hsm(b"\x01" * 32)
    client = hsm.client(TH.CAP_MASTER, b"\x02" * 33, dbid=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hsm.sign_htlc_batch(client, [bytes(32)],
                            hsm.per_commitment_point(client, 0))
    g = _one_channel_map()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoutePlanes.build(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMD.McfPlanes.build(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRD.RouteService(lambda: g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMD.McfService(lambda: g)
    assert RoutePlanes.build(g, device="cpu").device.type == "cpu"
    assert D.resolve("cpu") == torch.device("cpu")


def _one_channel_map() -> Gossmap:
    z = np.zeros((2, 1))
    g = Gossmap(node_ids=np.arange(66, dtype=np.uint8).reshape(2, 33),
                scids=np.array([1 << 40], np.uint64),
                node1=np.zeros(1, np.int32), node2=np.ones(1, np.int32),
                capacity_sat=np.zeros(1, np.float32),
                enabled=np.ones((2, 1), bool),
                cltv_delta=z.astype(np.uint16),
                htlc_min_msat=z.astype(np.uint64),
                htlc_max_msat=z.astype(np.uint64),
                fee_base_msat=z.astype(np.uint32),
                fee_ppm=z.astype(np.uint32),
                timestamps=np.ones((2, 1), np.uint32))
    g.ensure_adjacency()
    return g


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version for CPU tensors only; any other
    device launches the kernel or raises."""
    x = F.from_int_array([1, 2]).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        H.verify_prep_core(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        H.build_tables(x, x, torch.zeros(2, dtype=torch.int64,
                                         device="meta"))
    planes = torch.zeros((64, 3, 8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        H.dual_mul_planes(planes, planes)
    with pytest.raises(ValueError, match="unsupported device"):
        H.dual_mul_v2(planes[:, 0, 0], planes[:16], planes)
    with pytest.raises(ValueError, match="unsupported device"):
        H.glv_scan2(planes[:33, 0, 0], planes[:33, 0, 0], None,
                    planes[:33], planes[:33])
    e = torch.zeros(4, dtype=torch.int64, device="meta")
    q = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        HR.route_sweep(*(e,) * 7, torch.zeros((2, 4), dtype=torch.bool,
                                              device="meta"),
                       *(q,) * 5, 64, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        HR.mcf_solve(*(e,) * 6, torch.zeros((2, 2), dtype=torch.float64,
                                            device="meta"),
                     torch.zeros((2, 2), dtype=torch.int64, device="meta"),
                     *(q,) * 4, 64)


def test_launch_counters_start_at_zero_and_ignore_plain_calls():
    H.reset_launches()
    one = F.from_int_array([1])
    H.verify_prep_core(one, one)
    assert H.launch_counts() == {"verify_prep_core": 0, "build_tables": 0,
                                 "glv_scan": 0, "glv_scan2": 0,
                                 "dual_mul_v2": 0, "dual_mul_planes": 0,
                                 "fixed_base_affine": 0, "ecdsa_sign": 0}
    assert np.array_equal(F.to_bytes_be(one)[0, -1:], [1])
    HR.reset_launches()
    planes = RoutePlanes.build(_one_channel_map(), device="cpu")
    q = TRD.RouteQuery(bytes(planes.g.node_ids[0]),
                       bytes(planes.g.node_ids[1]), 1_000)
    assert TRD.solve_batch(planes, [q], batch=1)[0][0] == "ok"
    assert HR.launch_counts() == {"route_sweep": 0, "mcf_solve": 0}


def test_port_reads_no_environment_but_the_nvcc_path():
    """Knobs are arguments or module constants: the only environment
    variable the port reads is NVCC, the compiler's path, in the build."""
    pkg = os.path.join(ROOT, "lightning_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for n, line in enumerate(fh, 1):
                        if "os.environ" in line or "getenv(" in line:
                            hits.append((os.path.relpath(path, pkg), n))
    assert [h[0] for h in hits] == ["_build.py"]
