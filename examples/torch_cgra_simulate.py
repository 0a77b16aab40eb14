"""Map a switch program onto the CGRA and simulate its dataplane, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_cgra_simulate.py

The twin of ``examples/cgra_simulate.py`` on :mod:`repro_torch`.  No mesh
needed: the compiler's PlaceCGRA pass maps every stage's compute body onto
the paper's §IV switch grid (or falls back to the host with an explicit
reason), and the discrete-event simulator executes the compiled program
across 8 simulated ranks held in one tensor on the card — one kernel
launch a ring step (``prefix_sum`` for Fig. 5's scan, ``fused_combine``,
``quant_combine`` on the int8 pod hop, ``topk_accumulate``) — checking the
numerics against plain numpy and printing the simulated latency next to
the analytic netmodel prediction.  Both are the cost model's figures for
the paper's switch, not times on the card.

Where the reference's mapper falls back to the host for the int8 stages
(its ``primitive 'jit'``), the port's ``make_fx`` mapper places them.
"""

import argparse

import numpy as np
import torch

from repro_torch import core as acis
from repro_torch.cgra.simulate import SwitchSim
from repro_torch.core.types import TensorSpec
from repro_torch.mesh import default_device


def AV(shape):
    return TensorSpec(shape, torch.float32)


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Runs the three simulations on ``device`` (the card unless the
    caller asks for the CPU) at the reference's sizes and returns what
    they print (no model runs here, so ``cfg`` is unused)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    rng = np.random.default_rng(0)
    n = 8
    got: dict = {}

    # -- Fig. 5: AG ∘ prefix-scan ∘ AG, fused to one in-network stage ----
    eng = acis.make_engine("acis")
    fig5 = eng.compile(
        lambda x: acis.all_gather(acis.scan(acis.all_gather(x))),
        in_avals=(AV((2048,)),), axis_size=n)
    print(fig5.explain(), "\n")

    x = rng.standard_normal((n, 2048)).astype(np.float32)
    sim = SwitchSim(eng.topology(axis_size=n))
    out, report = sim.run(fig5, torch.from_numpy(x).to(dev))
    # numpy's f32 cumsum adds in order and the port's scan in its own
    # order (the kernel: tiles with a look-back carry), so the port is
    # also held to the float64 sum
    err = float(np.abs(out[0].cpu().numpy() - np.cumsum(x.reshape(-1)))
                .max())
    err64 = float(np.abs(out.cpu().numpy()
                         - np.cumsum(x.reshape(-1).astype(np.float64))).max())
    print(report.table())
    print(f"numerics vs numpy cumsum: max err {err:.2e} "
          f"(vs the float64 sum: {err64:.2e})\n")
    got["fig5"] = {"program": fig5, "input": x, "out": out,
                   "report": report, "err": err, "err_f64": err64,
                   "sim_us": report.t_sim * 1e6,
                   "model_us": report.t_model * 1e6}

    # -- compressed sync: the int8 compressor is *placed*, top-k is not --
    engc = acis.make_engine("acis_compressed")
    for compressor in ("int8", "topk"):
        prog = engc.compile(
            lambda v: acis.ef_reduce(v, axis="data",
                                     compressor=compressor)[0],
            in_avals=(AV((16384,)),), axis_size=n)
        (st,) = prog.stages
        print(f"ef_reduce[{compressor}]: {st.placement.describe()}")
        g = rng.standard_normal((n, 16384)).astype(np.float32)
        _, rep = sim.run(prog, torch.from_numpy(g).to(dev))
        print(f"  simulated {rep.t_sim * 1e6:8.2f} us   "
              f"analytic {rep.t_model * 1e6:8.2f} us")
        got[compressor] = {"program": prog, "input": g, "report": rep,
                           "placement": st.placement.describe(),
                           "sim_us": rep.t_sim * 1e6,
                           "model_us": rep.t_model * 1e6}
    print()

    # -- hierarchical pod mesh: per-tier links, codec on the thin hop ----
    engh = acis.make_engine("acis_hierarchical_compressed",
                            inner_axis="data", outer_axis="pod")
    sizes = {"data": 4, "pod": 2}
    sync = engh.compile(lambda g: acis.reduce(g, axis="auto"),
                        in_avals=(AV((16384,)),), axis_size=sizes)
    print(sync.explain(), "\n")
    g = rng.standard_normal((4, 2, 16384)).astype(np.float32)
    simh = SwitchSim(engh.topology(axis_size=sizes))
    out, rep = simh.run(sync, torch.from_numpy(g).to(dev))
    err = float(np.abs(out.cpu().numpy() - g.reshape(8, 16384).sum(0)).max()
                / np.abs(g).sum(0).max())
    print(rep.table())
    print(f"hierarchical sum vs numpy (int8-lossy, relative): {err:.2e}")
    got["hierarchical"] = {"program": sync, "input": g, "out": out,
                           "report": rep, "rel_err": err,
                           "sim_us": rep.t_sim * 1e6,
                           "model_us": rep.t_model * 1e6}
    return got


if __name__ == "__main__":
    main()
