"""The main path's store replay on this checkout and an earlier one, in turns.

    python -m lightning_tpu_torch.replay_ab --parent DIR [--reps 5]
        [--rounds 1] [--out FILE]

Synthesizes the store of chip_smoke.py's phase 3 (100,000 channels,
12,500 nodes, 612,500 signatures, seed 7) on the card once, then replays
it through ``load_store -> check_crcs -> verify_store`` at each
checkout's defaults (its main path) in processes that import the port
package from this checkout ("change") or from DIR, the root of an
earlier checkout ("parent"), in the order parent, change, change, parent
(``--rounds`` times).  Each process builds its own checkout's kernels,
replays once to warm up, then ``--reps`` times, checks every verdict
against the seeded ones, and reports each replay's wall time.  Prints
one JSON line: every process's times and each side's median sig/s.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# run in each process with the checkout's root as its working directory
_WORKER = r"""
import json, sys, time
import numpy as np, torch
from lightning_tpu_torch import _build
from lightning_tpu_torch.gossip import store, verify
path, expected, reps, bucket = sys.argv[1], np.load(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4])
t0 = time.perf_counter()
_build.build_all()
t_build = time.perf_counter() - t0


def replay():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = store.load_store(path)
    assert idx.check_crcs().all(), "store crc mismatch"
    res = verify.verify_store(idx, bucket, device="cuda")
    t = time.perf_counter() - t0
    assert np.array_equal(res.sig_ok, expected), "wrong verdicts"
    return t, res.n_sigs


replay()
times, n = zip(*(replay() for _ in range(reps)))
print(json.dumps({"build_s": t_build, "replay_s": list(times),
                  "sigs": n[0]}))
"""


def _run(root: str, path: str, expected: str, reps: int,
         bucket: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _WORKER, path, expected, str(reps),
         str(bucket)], cwd=root, capture_output=True, text=True,
        timeout=1200)
    if out.returncode:
        raise RuntimeError(f"replay in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--channels", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=12_500)
    ap.add_argument("--bucket", type=int, default=65536)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("replay_ab: no CUDA device", file=sys.stderr)
        return 2
    from .gossip import synth

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"parent": os.path.abspath(args.parent), "change": here}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with tempfile.TemporaryDirectory(prefix="replay_ab_") as tmp:
        path = os.path.join(tmp, "store.gs")
        info = synth.make_network_store(
            path, args.channels, args.nodes, seed=7, device="cuda",
            n_corrupt=64, off_curve=1, bad_tag=1, oversized=3)
        expected = os.path.join(tmp, "expected.npy")
        np.save(expected, info["expected_sig_ok"])
        runs = []
        for _ in range(args.rounds):
            for side in ("parent", "change", "change", "parent"):
                r = _run(roots[side], path, expected, args.reps, args.bucket)
                r["side"] = side
                runs.append(r)
                print(f"{side}: build {r['build_s']:.1f} s, replays "
                      f"{[round(t, 4) for t in r['replay_s']]} s",
                      file=sys.stderr, flush=True)
    sigs = info["sigs"]
    median = {side: sigs / float(np.median([t for r in runs
                                            if r["side"] == side
                                            for t in r["replay_s"]]))
              for side in roots}
    line = json.dumps({"card": card.strip(), "sigs": sigs,
                       "median_sig_s": median, "runs": runs})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
