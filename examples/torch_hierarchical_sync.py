"""Topology-aware compilation on a pod mesh, on the PyTorch port.

    PYTHONPATH=src python examples/torch_hierarchical_sync.py

The twin of ``examples/hierarchical_sync.py`` on :mod:`repro_torch`.  One
reduce over ``axis="auto"`` is all the program says; the compiler's
LowerTopology pass knows the mesh has a fast intra-pod axis ("data") and
a ~10x thinner inter-pod axis ("pod"), lowers the reduce to the
hierarchical RS(data) -> AR(pod) -> AG(data) schedule, and places the
engine's wire codec on the thin inter-pod hop only.  The port also runs
each compiled program once on ``LocalMesh({"pod": 2, "data": 4})``: its
ring hops are the ``fused_hop`` kernel, the int8 pod hop ``quant_hop``.

Where the reference prints ``host-fallback: ... primitive 'jit'`` for the
int8 pod hop (its mapper cannot see through a nested ``jit``), the port's
``make_fx`` mapper places that stage, and the table says so.
"""

import argparse

import numpy as np
import torch

from repro_torch import core as acis
from repro_torch.core.types import TensorSpec
from repro_torch.mesh import LocalMesh, default_device


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Runs the demo on ``device`` (the card unless the caller asks for
    the CPU) at the reference's sizes and returns what it prints (no model
    runs here, so ``cfg`` is unused)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    mesh = LocalMesh({"pod": 2, "data": 4}, device=dev)
    print(f"mesh: pod=2 x data=4 ({mesh.n_ranks} ranks on one {dev.type} "
          "device)\n")
    run_rng = np.random.default_rng(1)
    got: dict = {"programs": {}}

    for backend in ("acis_hierarchical", "acis_hierarchical_compressed"):
        eng = acis.make_engine(backend, inner_axis="data", outer_axis="pod")
        compiled = eng.compile(
            lambda g: acis.reduce(g, axis="auto"),
            in_avals=(TensorSpec((1 << 16,), torch.float32),),
            axis_size={"data": 4, "pod": 2})

        print(f"== {backend} ==")
        print("program: reduce(g, axis='auto')")
        # the compiled program explains itself: kind/axis/schedule/codec
        # and the CGRA placement (or host fallback) per stage
        explain = compiled.explain()
        print(explain)
        red = next(nd.op for nd in compiled.source.nodes
                   if nd.op.kind.value == "reduce")
        print(f"  -> wire codec on the inter-pod hop: {red.codec.name}")
        # the program on the mesh: [pod, data, 2^16] in, every rank's sum
        g = torch.from_numpy(run_rng.standard_normal((2, 4, 1 << 16))
                             .astype(np.float32)).to(dev)
        with mesh:
            (total,) = compiled(g)
        err = float((total.double() - g.double().sum((0, 1))).abs().max()
                    / g.double().abs().sum((0, 1)).max())
        print(f"  -> on the mesh: sum vs exact (relative): {err:.2e}\n")
        got["programs"][backend] = {
            "explain": explain, "stages": compiled.stage_kinds(),
            "codec": red.codec.name, "rel_err": err}

    # and the whole gradient-sync path, end to end on the mesh
    eng = acis.make_engine("acis_hierarchical", inner_axis="data",
                           outer_axis="pod")
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 1000)).astype(np.float32)
    with mesh:
        synced, _ = eng.gradient_sync(
            {"g": torch.from_numpy(g.reshape(2, 4, 1000)).to(dev)}, None)
    out = synced["g"].cpu().numpy()
    err = float(np.abs(out[0, 0] - g.mean(0)).max())
    print(f"gradient_sync vs flat mean: max err {err:.2e}")

    prog = eng.last_sync_program()
    stages = [f"{k}@{a}" if a else k
              for k, a in zip(prog.stage_kinds(), prog.stage_axes())]
    print("compiled sync stages:", stages)
    got.update(sync_err=err, synced=synced["g"], sync_stages=stages)
    return got


if __name__ == "__main__":
    main()
