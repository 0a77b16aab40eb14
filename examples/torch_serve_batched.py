"""Batched serving on the PyTorch port: continuous batching + the compiled
data path.

    PYTHONPATH=src python examples/torch_serve_batched.py          # the card
    PYTHONPATH=src python examples/torch_serve_batched.py --smoke  # small

The twin of ``examples/serve_batched.py`` on :mod:`repro_torch`.

Part 1 submits a burst of requests with heterogeneous prompt/generation
lengths to a 4-slot engine over the ~100M model (its published width on
the card; ``--smoke`` takes the reduced config the reference uses) and
verifies a completion against an independent greedy decode.

Part 2 reruns the same burst with the decode collectives compiled
through ``engine.compile``: the model runs rank-local over a 2-way
tensor-parallel ``LocalMesh({"tp": 2})`` and every per-layer all-reduce
is a switch program from the process-wide
:data:`repro_torch.serve.PROGRAM_CACHE` (its ring hops the ``fused_hop``
or ``fused_combine`` kernel).  A second engine replica then shows the
point of the shared cache — zero new compiles, all hits — and the decode
program's ``explain()`` prints the schedule the switch compiler picked.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.mesh import default_device
from repro_torch.models import Model
from repro_torch.serve import (PROGRAM_CACHE, Request, ServeCollectives,
                               ServeEngine)


def make_requests(cfg, rng, n=10):
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 3 + (i * 3) % 9)
                    .astype(np.int32),
                    max_new_tokens=4 + (i * 5) % 12)
            for i in range(n)]


def run_burst(eng, reqs) -> dict:
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    gen = sum(len(c.tokens) for c in done)
    print(f"  {len(done)} completions, {gen} tokens, {eng.ticks} ticks "
          f"in {dt:.1f}s ({gen / dt:.1f} tok/s, "
          f"{gen / max(eng.ticks, 1):.2f} tok/tick)")
    return {"completions": {c.rid: list(c.tokens) for c in done},
            "tokens": gen, "ticks": eng.ticks, "seconds": dt,
            "tokens_per_s": gen / dt}


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Runs both parts on ``device`` (the card unless the caller asks for
    the CPU) and returns what they print; ``cfg`` replaces the acis-100m
    config."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced acis-100m config (CPU-sized)")
    args = ap.parse_args(argv)
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    if cfg is None:
        cfg = configs.get_smoke("acis-100m") if args.smoke \
            else configs.get("acis-100m")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(42)
    reqs = make_requests(cfg, rng)
    got: dict = {"model": cfg.name}

    print("plain transport (one device, network free):")
    eng = ServeEngine(model, params, slots=4, max_seq=96)
    got["plain"] = run_burst(eng, reqs)

    # verify one completion against an oracle greedy decode
    req = reqs[3]
    toks = list(req.prompt)
    with torch.no_grad():
        for _ in range(req.max_new_tokens):
            h, _ = model.forward(params, torch.tensor([toks],
                                                      dtype=torch.int32,
                                                      device=dev))
            toks.append(int(model.logits(params, h)[0, -1].argmax()))
    want = toks[len(req.prompt):]
    got["oracle"] = want
    assert got["plain"]["completions"][3] == want, \
        (got["plain"]["completions"][3], want)
    print("  oracle check ✓")

    print("\ncompiled transport (tp=2, switch programs from the shared "
          "cache):")
    with obs.recording() as rec:
        sc = ServeCollectives(cfg, tp=2, device=dev)
        eng = ServeEngine(model, params, slots=4, max_seq=96,
                          collectives=sc)
        got["compiled"] = run_burst(eng, make_requests(cfg, rng))
        got["cache"] = PROGRAM_CACHE.stats()
        got["decode_p50_s"] = rec.gauges["serve.decode_p50_s"]
        got["decode_p99_s"] = rec.gauges["serve.decode_p99_s"]
        print(f"  program cache: {got['cache']}")
        print(f"  decode p50 {got['decode_p50_s'] * 1e3:.1f}ms "
              f"p99 {got['decode_p99_s'] * 1e3:.1f}ms")

        # a second replica reuses every program — no recompiles
        miss0 = PROGRAM_CACHE.stats()["misses"]
        eng2 = ServeEngine(model, params, slots=4, max_seq=96,
                           collectives=ServeCollectives(cfg, tp=2,
                                                        device=dev))
        got["replica2"] = run_burst(eng2, make_requests(cfg, rng))
        stats = PROGRAM_CACHE.stats()
        got["replica2_new_compiles"] = stats["misses"] - miss0
        got["cache_after"] = stats
        print(f"  replica 2: {stats['misses'] - miss0} new compiles, "
              f"{stats['hits']} total hits")

    programs = sc.decode_programs(4)
    name, prog, count = programs[0]
    print(f"\ndecode tick runs {count}× {name}:")
    got["decode_program"] = {"name": name, "calls_per_tick": count,
                             "explain": prog.explain(),
                             "programs": programs}
    print(got["decode_program"]["explain"])
    return got


if __name__ == "__main__":
    main()
