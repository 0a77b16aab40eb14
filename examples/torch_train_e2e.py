"""End-to-end training on the PyTorch port: the ~100M-param model with
ACiS gradient sync on the card.

    PYTHONPATH=src python examples/torch_train_e2e.py \\
        --backend acis_compressed --steps 300

The twin of ``examples/train_e2e.py`` on :mod:`repro_torch`: synthetic
bigram data → composable model → explicit in-network gradient sync
(shared-scale int8 with error feedback — Types 2+3) → AdamW → checkpoints
→ resume.  Loss must descend toward the bigram entropy floor; the final
report prints the wire-bytes saving of the compressed transport vs f32.
Every sync's ring hops are the ``fused_hop`` kernel and its bucket packs
``fused_pack``.

The reference's mesh is ``("data", "model") = (4, 2)``; its acis steps
split the batch over ``data`` and replicate over ``model``, so here the
acis backends run on ``LocalMesh({"data": 4})`` (``acis_hierarchical``
finds no ``pod`` axis there and syncs flat, as the reference's does), and
``--backend xla`` runs the FSDP x TP step on ``{"data": 4, "model": 2}``.
"""

import argparse
import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import configs, tree
from repro_torch.core import make_engine
from repro_torch.data.pipeline import BigramStream, DataConfig
from repro_torch.mesh import LocalMesh, default_device
from repro_torch.models import Model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import (build_train_step_acis,
                                    build_train_step_gspmd, init_state)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="acis_compressed",
                    choices=["xla", "acis", "acis_compressed",
                             "acis_hierarchical"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--arch", default="acis-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CI-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What one training run is built from: the step, its mesh and
    engine (None for ``xla``), the seeded initial state and the data."""

    cfg: Any
    model: Model
    optimizer: Any
    mesh: LocalMesh
    engine: Optional[Any]
    step: Any
    state: Any
    stream: BigramStream


def setup(args: argparse.Namespace, *, device="cuda", cfg=None) -> Run:
    """The model, optimizer, mesh, step, initial state (seed 0) and
    stream of ``args`` on ``device``; ``cfg`` replaces ``--arch``'s."""
    dev = default_device() if torch.device(device).type == "cuda" \
        else torch.device(device)
    if cfg is None:
        cfg = configs.get_smoke(args.arch) if args.smoke \
            else configs.get(args.arch)
    model = Model(cfg)
    optimizer = opt_lib.adamw(opt_lib.warmup_cosine(3e-4, 20, args.steps))
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.backend == "xla":
        mesh = LocalMesh({"data": 4, "model": 2}, device=dev)
        step = build_train_step_gspmd(model, optimizer, mesh)
        engine = None
        state = step.place_state(init_state(model, optimizer, gen,
                                            device=dev))
    else:
        mesh = LocalMesh({"data": 4}, device=dev)
        engine = make_engine(args.backend, inner_axis="data")
        # the persistent gradient-sync bucket arenas are written in place
        # every step (the pack transient is ~1x bucket size, not 2x)
        step = build_train_step_acis(model, optimizer, mesh, engine)
        state = init_state(model, optimizer, gen, engine, mesh=mesh,
                           arenas=True)
    stream = BigramStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=7))
    return Run(cfg, model, optimizer, mesh, engine, step, state, stream)


def train(args: argparse.Namespace, run: Run):
    """The loop of ``args`` from ``run``'s state, restored from
    ``--ckpt-dir`` when it holds a checkpoint: (loop, final state, steps
    run, host seconds of the steps)."""
    loop = TrainLoop(run.step, run.stream, LoopConfig(
        total_steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_every=max(args.steps // 4, 1), ckpt_dir=args.ckpt_dir))
    state = loop.maybe_restore(run.state)
    start = int(state.step)
    t0 = time.perf_counter()
    state = loop.run(state)
    if run.mesh.device.type == "cuda":
        torch.cuda.synchronize(run.mesh.device)
    return loop, state, args.steps - start, time.perf_counter() - t0


def main(argv=None, *, device="cuda", cfg=None) -> dict:
    """Trains on ``device`` (the card unless the caller asks for the
    CPU) and returns what it prints, with the final state and the run."""
    args = parse_args(argv)
    run = setup(args, device=device, cfg=cfg)
    cfg = run.cfg
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"backend={args.backend}")
    got: dict = {"model": cfg.name, "backend": args.backend,
                 "mesh": dict(run.mesh.axes), "steps": args.steps,
                 "global_batch": args.batch, "seq": args.seq}
    if run.state.sync_arenas is not None:
        sizes = [a.numel() * a.element_size()
                 for a in run.state.sync_arenas]
        got["arena_bytes"] = sum(sizes)
        print(f"sync arenas: {len(sizes)} buckets, "
              f"{sum(sizes) / 1e6:.1f} MB (written in place)")
    got["entropy"] = run.stream.entropy()
    print(f"data: bigram entropy floor = {got['entropy']:.3f} nats")

    loop, state, steps_run, dt = train(args, run)
    engine = run.engine
    if engine is not None and engine.last_sync_program() is not None:
        # the compiled switch program gradient_sync actually ran: the
        # Coalesce buckets and the ExecutionPlan wave structure per stage
        compiled_sync = engine.last_sync_program()
        got["sync_program"] = compiled_sync
        got["sync_us_model"] = compiled_sync.program_time() * 1e6
        print("\ngradient-sync switch program "
              f"(analytic {got['sync_us_model']:.1f}us/sync):")
        print(compiled_sync.explain())

    first = loop.metrics_log[0]["nll"]
    last = loop.metrics_log[-1]["nll"]
    print("\nstep,nll,accuracy")
    for m in loop.metrics_log:
        print(f"{m['step']},{m['nll']:.4f},{m['accuracy']:.4f}")
    toks = steps_run * args.batch * args.seq
    print(f"\n{steps_run} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s); nll {first:.3f} → {last:.3f} "
          f"(floor {got['entropy']:.3f})")
    got.update(curve=[[m["step"], m["nll"], m["accuracy"]]
                      for m in loop.metrics_log],
               nll_first=first, nll_last=last, steps_run=steps_run,
               seconds=dt, tokens_per_s=toks / dt, state=state, run=run)
    if engine is not None and engine.compressed:
        params = sum(p.numel() for p in tree.tree_leaves(state.params))
        got["wire_mb_f32"] = 2 * 4 * params / 1e6
        got["wire_mb_int16"] = 2 * 2 * params / 1e6
        print(f"wire per sync: f32 ring {got['wire_mb_f32']:.1f} MB-eq "
              f"→ int16-partials {got['wire_mb_int16']:.1f} MB-eq "
              f"(+1/256 scales) — 2.0x reduction, EF-exact")
    bar = 0.5 if args.steps >= 200 else 0.1
    assert last < first - bar, \
        f"training failed to descend ({first:.3f} -> {last:.3f})"
    print("OK")
    return got


if __name__ == "__main__":
    main()
