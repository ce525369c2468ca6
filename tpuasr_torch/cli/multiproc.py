"""Multi-process launcher (port of ``tpuasr/cli/multiproc.py``).

Starts one copy of a command a rank, as the reference's multiproc.py
started one train.py a GPU: each child gets ``TPUASR_PROCESS_ID``,
``TPUASR_NUM_PROCESSES`` and ``TPUASR_COORDINATOR`` in its environment
and ``--rank R --world-size N --dist-url URL`` after its arguments.
Returns nonzero if any child fails; a child that fails stops the others,
which would otherwise wait in a collective for it.

Usage:
  python -m tpuasr_torch.cli.multiproc --world-size 2 -- \
      python -m tpuasr_torch.cli.train --train-manifest ... --world-size 2
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch multi-process launcher")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--dist-url", default="localhost:12355",
                   help="rendezvous address host:port")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to launch per process (after --)")
    args = p.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given (pass it after --)")

    procs = []
    for rank in range(args.world_size):
        env = dict(os.environ)
        env.update({
            "TPUASR_PROCESS_ID": str(rank),
            "TPUASR_NUM_PROCESSES": str(args.world_size),
            "TPUASR_COORDINATOR": args.dist_url,
        })
        full = cmd + ["--rank", str(rank), "--world-size", str(args.world_size),
                      "--dist-url", args.dist_url]
        procs.append(subprocess.Popen(full, env=env))

    rc = 0
    try:
        while True:
            codes = [pr.poll() for pr in procs]
            if all(c is not None for c in codes) or any(codes):
                break  # all done, or a failed rank the others would wait for
            time.sleep(0.1)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
        for pr in procs:
            try:
                rc |= pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                rc |= pr.wait() or 1
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
