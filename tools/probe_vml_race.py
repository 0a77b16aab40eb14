#!/usr/bin/env python3
"""Count wrong first parallel ``tanh`` calls in fresh processes (F4).

    python3 tools/probe_vml_race.py [--waves 12] [--width 8]

Each process computes ``torch.tanh`` of the F4 test's input ([8, 4096]
f32, so 8 OpenMP threads take a chunk each) twice and reports whether
the first call differs from the second.  ``--width`` processes run at
once, ``--waves`` times over, first with nothing before the call, then
after ``import repro_torch`` (which sets MKL's VML up on one thread).
Prints one JSON object with the counts of each arm.  CPU only.

    python3 tools/probe_vml_race.py --bits

rebuilds F4's failing output instead: the simulator's map output was
``tanh(x) * 2`` with OpenMP thread 7's chunk (the last 4,096 of 32,768
elements) computed by MKL VML's ``vmsTanh`` in EP mode on its AVX2 path,
the provisional path; folding that through the port's ring all-reduce
gives the failing run's bits (element 0 0xBDED01C4 for 0xBDED0A1C,
51,056 of 131,072 bytes apart).  Needs a torch build that exports MKL's
VML (``libtorch_cpu.so``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import sys
if sys.argv[1] == "set_up":
    sys.path.insert(0, sys.argv[2])
    import repro_torch  # noqa: F401
import numpy as np
import torch
x = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (8, 4096)).astype(np.float32))
first, again = torch.tanh(x), torch.tanh(x)
rows = (first != again).reshape(8, -1).any(1).nonzero().flatten().tolist()
print(",".join(map(str, rows)))
"""


def arm(name: str, waves: int, width: int) -> dict:
    wrong, threads = 0, []
    for _ in range(waves):
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, name,
                                   str(ROOT / "src")],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(width)]
        for p in procs:
            out = p.communicate()[0].strip()
            if out:
                wrong += 1
                threads += [int(r) for r in out.split(",")]
    return {"processes": waves * width, "wrong_first_call": wrong,
            "wrong_chunks_by_thread": sorted(threads)}


BITS_CHILD = """
import ctypes, sys, numpy as np
f = ctypes.CDLL(sys.argv[1]).vmsTanh
f.restype = None
f.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_uint64]
x = np.random.default_rng(0).standard_normal((8, 4096))
row = np.ascontiguousarray(x.astype(np.float32)[7])
out = np.empty_like(row)
f(4096, row.ctypes.data, out.ctypes.data, 0x3 | 0x140000 | 0x100)
sys.stdout.write(out.tobytes().hex())
"""


def bits() -> dict:
    """F4's output rebuilt: thread 7's chunk from EP-mode AVX2 vmsTanh
    (in a child process limited to AVX2), folded through the ring."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import collectives
    from repro_torch.mesh import LocalMesh

    lib = Path(torch.__file__).parent / "lib" / "libtorch_cpu.so"
    ran = subprocess.run([sys.executable, "-c", BITS_CHILD, str(lib)],
                         capture_output=True, text=True, timeout=120,
                         check=True, env=dict(os.environ,
                                              MKL_ENABLE_INSTRUCTIONS="AVX2"))
    ep = torch.from_numpy(np.frombuffer(bytes.fromhex(ran.stdout),
                                        np.float32).copy())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 1 << 12)).astype(np.float32))
    good = torch.tanh(x)
    bad = good.clone()
    bad[7] = ep
    with LocalMesh({"data": 8}, device="cpu"):
        want = collectives.all_reduce(good * 2, "data")
        got = collectives.all_reduce(bad * 2, "data")
    return {"element0_right": hex(want.numpy().view(np.uint32)[0, 0]),
            "element0_rebuilt": hex(got.numpy().view(np.uint32)[0, 0]),
            "bytes_apart": int((got.numpy().view(np.uint8)
                                != want.numpy().view(np.uint8)).sum()),
            "bytes": got.numel() * got.element_size()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--waves", type=int, default=12)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--bits", action="store_true",
                    help="rebuild F4's failing output instead")
    args = ap.parse_args()
    if args.bits:
        print(json.dumps(bits()))
        return 0
    print(json.dumps({name: arm(name, args.waves, args.width)
                      for name in ("cold", "set_up")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
