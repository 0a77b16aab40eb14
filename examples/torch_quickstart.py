"""Quickstart on the PyTorch port: the ACiS engine in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py          # the card
    PYTHONPATH=src python examples/torch_quickstart.py --smoke  # small model

The twin of ``examples/quickstart.py`` on :mod:`repro_torch`, all eight
ranks of the mesh held in one tensor on one card:

1.  Trace a switch program from a plain Python function, compile it
    through the pass pipeline, and run it on an 8-rank mesh — the Fig. 5
    fused Allgather_op_Allgather in three lines (its local scan is the
    ``prefix_sum`` kernel).
2.  Trace a *two-tensor* program (the NAS-IS histogram/keys pair) — one
    fused in-network program with two inputs and two outputs (its reduce
    hops run the ``fused_combine`` kernel).
3.  Run a Type 2 user-defined collective (Welford mean/variance) that a
    fixed-function switch cannot express.
4.  Forward an assigned architecture (qwen3-8b at its published width;
    ``--smoke`` takes the reduced config) through one step.
"""

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import core as acis
from repro_torch.core import collectives
from repro_torch.core.types import WELFORD, TensorSpec
from repro_torch.mesh import P, LocalMesh, default_device
from repro_torch.models import Model


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Runs the four parts on ``device`` (the card unless the caller asks
    for the CPU) and returns what they print; ``cfg`` replaces the
    qwen3-8b config (a depth cut, say)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced qwen3-8b config (CPU-sized)")
    args = ap.parse_args(argv)
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    mesh = LocalMesh({"data": 8}, device=dev)
    engine = acis.make_engine("acis")

    # -- 1. Type 4 fused collective via trace + the pass pipeline ------------
    def fem(x):
        return acis.all_gather(acis.scan(acis.all_gather(x)))

    # in_avals are the rank-local shapes: they size the schedule choice
    # (latency vs bandwidth ring) and keep program_time fully priced
    fn = engine.compile(fem, mesh, P("data"), P(None),
                        in_avals=(TensorSpec((4,), torch.float32),))
    x = torch.arange(32.0, device=dev)
    out = fn(x)
    print("fused stages:", fn.stages)
    np.testing.assert_allclose(out.cpu().numpy(), np.cumsum(x.cpu().numpy()),
                               rtol=1e-5)
    print("fig5 fused allgather_op_allgather ✓  (prefix sum in-network)")

    # -- 2. multi-tensor program: AR + A2A share one ring traversal ----------
    def histogram_shuffle(hist, keys):
        return acis.reduce(hist), acis.all_to_all(keys)

    fn2 = engine.compile(histogram_shuffle, mesh,
                         (P("data", None), P("data")),
                         (P("data", None), P("data")),
                         in_avals=(TensorSpec((1, 16), torch.float32),
                                   TensorSpec((8,), torch.float32)))
    hist = torch.ones((8, 16), device=dev)
    keys = torch.arange(64.0, device=dev)
    h, k = fn2(hist, keys)
    hist_sum = float(h[0, 0])
    print(f"nas-is fused stages: {fn2.stages}  "
          f"hist sum={hist_sum:.0f} (expect 8)")

    # -- 3. Type 2 user-defined collective ----------------------------------
    data = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                            .astype(np.float32)).to(dev)
    with mesh:
        xl = mesh.shard(data, P("data"))      # [8 ranks, 8]
        n, m, s = collectives.all_reduce(
            (torch.ones_like(xl), xl, torch.zeros_like(xl)), "data",
            WELFORD, latency_optimal=True)
    mean, var = mesh.unshard(m, P("data")), mesh.unshard(s / n, P("data"))
    # positionwise stats across the 8 ranks (each holds 8 of 64 elements)
    ref = data.cpu().numpy().reshape(8, 8)
    print(f"welford in-network: mean={float(mean[0]):+.4f} "
          f"var={float(var[0]):.4f} "
          f"(numpy: {ref.mean(0)[0]:+.4f} {ref.var(0)[0]:.4f})")

    # -- 4. one of the assigned architectures ---------------------------------
    if cfg is None:
        cfg = configs.get_smoke("qwen3-8b") if args.smoke \
            else configs.get("qwen3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    toks = torch.ones((2, 16), dtype=torch.int32, device=dev)
    with torch.no_grad():
        hidden, _ = model.forward(params, toks)
    ok = bool(torch.isfinite(hidden).all())
    assert ok, "non-finite hidden states"
    print(f"{cfg.name} forward: hidden {tuple(hidden.shape)} ✓")
    return {"fig5_stages": list(fn.stages), "fig5_out": out,
            "nas_is_stages": list(fn2.stages), "hist_sum": hist_sum,
            "hist": h, "keys": k, "welford_mean": mean, "welford_var": var,
            "numpy_mean": ref.mean(0), "numpy_var": ref.var(0),
            "model": cfg.name, "layers": cfg.n_layers,
            "hidden_shape": tuple(hidden.shape), "hidden_finite": ok}


if __name__ == "__main__":
    main()
