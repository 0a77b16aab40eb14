"""Tour of the ACiS taxonomy on the PyTorch port (Types 0-4).

    PYTHONPATH=src python examples/torch_fused_collectives.py

The twin of ``examples/fused_collectives.py`` on :mod:`repro_torch`: every
taxonomy level through the port on an 8-rank ``LocalMesh`` (all ranks in
one tensor on the card), with the wire-bytes accounting next to each
(what a switch/link would carry).  The rings' hops run the
``fused_combine`` kernel (its ring-hop form) and the fused all-gather's
local scan the ``prefix_sum`` kernel.
"""

import argparse

import numpy as np
import torch

from repro_torch import core as acis
from repro_torch.core import collectives, fused, switchops
from repro_torch.core.lookaside import (error_feedback_all_reduce,
                                        powersgd_all_reduce)
from repro_torch.core.types import ADD, MAX, TensorSpec
from repro_torch.core.wire import BF16
from repro_torch.mesh import P, LocalMesh, default_device


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Runs the tour on ``device`` (the card unless the caller asks for
    the CPU) at the reference's sizes and returns what it prints (no model
    runs here, so ``cfg`` is unused)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    mesh = LocalMesh({"data": 8}, device=dev)
    rng = np.random.default_rng(0)
    n, dim = 8, 1 << 16
    x = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32)) \
        .to(dev)                          # [rank, dim]: P("data", None)
    f32_wire = 2 * (n - 1) / n * dim * 4
    got = {"x": x}

    with mesh:
        # Type 0/1: ring allreduce with a bf16 wire codec; each hop's add
        # is the switch's combine kernel (switchops.hop_kernel)
        out = collectives.all_reduce(x, "data", ADD, codec=BF16,
                                     hop_combine=switchops.hop_kernel("add"))
        got["bf16_err"] = float((out[0] - x.sum(0)).abs().max())
        got["bf16_out"] = out
        print(f"Type 0+1  bf16-wire ring allreduce      "
              f"wire/elt {f32_wire * 0.5 / dim:.2f}B "
              f"(f32: {f32_wire / dim:.2f}B)  err={got['bf16_err']:.3f}")

        # Type 2: max-reduce (works on acis; xla can't take custom monoids)
        got["max_out"] = collectives.all_reduce(
            x, "data", MAX, hop_combine=switchops.hop_kernel("max"))
        got["max_match"] = bool(torch.allclose(got["max_out"][0],
                                               x.max(0).values))
        print(f"Type 2    user monoid (max) allreduce    ✓ "
              f"match={got['max_match']}")

        # Type 3: stateful compressed sync with error feedback
        red, res = error_feedback_all_reduce(
            x, torch.zeros((n, dim), device=dev), "data", use_kernels=True)
        got["ef_reduced"], got["ef_residual"] = red, res
        got["ef_residual_max"] = float(res.abs().max())
        print(f"Type 3    int8+EF allreduce              wire/elt ~2.0B  "
              f"residual|max|={got['ef_residual_max']:.4f} "
              f"(look-aside memory)")

        # Type 3: the loop-inside-collective (PowerSGD rank-4); the warm
        # start q is replicated: every rank holds a copy
        m = torch.from_numpy(rng.standard_normal((n, 128, 64))
                             .astype(np.float32)).to(dev)
        q0 = torch.from_numpy(rng.standard_normal((64, 4))
                              .astype(np.float32)).to(dev)
        got["powersgd"], _, got["powersgd_residual"] = powersgd_all_reduce(
            m, q0.expand(n, 64, 4), torch.zeros((n, 128, 64), device=dev),
            "data")
        print(f"Type 3    PowerSGD rank-4 allreduce      wire "
              f"{4 * 4 * (128 + 64)}B vs dense {128 * 64 * 4}B "
              f"({128 * 64 * 4 / (4 * 4 * (128 + 64)):.1f}x less)")

        # Type 4: fused allgather_op_allgather vs two rounds
        flat = x.reshape(-1)[:n * 1024]
        fem = fused.allgather_op_allgather(mesh.shard(flat, P("data")),
                                           "data", use_kernels=True)
        got["fused_out"] = mesh.unshard(fem, P(None))
        got["fused_match"] = bool(torch.allclose(
            got["fused_out"], torch.cumsum(flat, 0), atol=1e-2))
        print(f"Type 4    allgather_op_allgather fused   one gather round "
              f"(baseline: two)  match={got['fused_match']}")

    # Type 4: traced multi-tensor program through the pass pipeline —
    # map∘reduce on one input rides next to an alltoall on the other,
    # with the schedule chosen from the payload bytes.
    eng = acis.make_engine("acis", latency_optimal_below=16384)

    def histshuf(hist, keys):
        return acis.reduce(acis.map(torch.square, hist)), \
            acis.all_to_all(keys)

    fprog = eng.compile(
        histshuf, mesh, (P("data", None), P("data")),
        (P("data", None), P("data")),
        in_avals=(TensorSpec((1, 128), torch.float32),
                  TensorSpec((1024,), torch.float32)))
    got["dag_hist"], got["dag_keys"] = fprog(
        torch.ones((n, 128), device=dev),
        torch.arange(float(n * 1024), device=dev))
    got["dag_stages"] = list(fprog.stages)
    got["dag_schedules"] = [s or "-" for s in fprog.schedules]
    print(f"Type 4    traced DAG program            stages={fprog.stages} "
          f"schedules={got['dag_schedules']}")

    # Type 4: collective matmul (compute rides the ring)
    xm = torch.from_numpy(rng.standard_normal((64, 32))
                          .astype(np.float32)).to(dev)
    wm = torch.from_numpy(rng.standard_normal((32, 64))
                          .astype(np.float32)).to(dev)
    with mesh:
        y = fused.allgather_matmul(mesh.shard(xm, P("data", None)),
                                   mesh.shard(wm, P(None, "data")), "data")
    got["matmul_out"] = mesh.unshard(y, P(None, "data"))
    got["matmul_match"] = bool(torch.allclose(got["matmul_out"], xm @ wm,
                                              atol=1e-3))
    print(f"Type 4    collective matmul              per-hop MAC hides "
          f"rotation  match={got['matmul_match']}")
    return got


if __name__ == "__main__":
    main()
