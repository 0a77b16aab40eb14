"""The attribution of device operations and idle gaps to the port's spans
(``harness/program.py``) on hand-built trace events, its readers, the
second pass on the CPU, and on a card a train step with spans on."""

import json

import pytest
import torch

from portbench.harness import counts, program

H100 = "NVIDIA H100 80GB HBM3"


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": "acis." + name,
            "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def test_ops_belong_to_the_innermost_span_of_their_launch():
    events = [
        span("train.step", 0, 100), span("train.forward", 0, 40),
        span("train.backward", 40, 50), span("train.update", 90, 10),
        launch(1, 10), kernel(1, 50, 10),
        # the backward's launch, from autograd's own thread
        launch(2, 50, tid=2), kernel(2, 70, 10),
        launch(3, 95), kernel(3, 100, 5),
        launch(4, 120), kernel(4, 130, 5),
        kernel(5, 140, 5),                       # no launch seen
        {"ph": "X", "cat": "gpu_user_annotation", "name": "acis.train.step",
         "ts": 50, "dur": 55, "pid": 0, "tid": 7},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 10, "id": 1},
    ]
    got = program.attribute(events)
    names = [s[0] for s in got["spans"]]
    assert names == ["acis.train.step", "acis.train.forward",
                     "acis.train.backward", "acis.train.update"]
    assert [s[3] for s in got["spans"]] == [None, 0, 0, 0]
    owners = [None if o is None else names[o] for *_, o in got["ops"]]
    assert owners == ["acis.train.forward", "acis.train.backward",
                      "acis.train.update", None, None]
    rec = {"program": got}
    read = program.READERS
    assert read["forward_ms.train"](rec) == pytest.approx(0.010)
    assert read["backward_ms.train"](rec) == pytest.approx(0.010)
    assert read["optimizer_ms.train"](rec) == pytest.approx(0.005)
    assert read["step_sync_ms.train"](rec) == 0.0
    assert read["ring_ms.sync"](rec) is None       # no sync.call root


def test_a_spans_device_ms_is_the_union_per_call():
    events = [span("sync.call", 0, 100), span("stage.allreduce", 0, 50),
              span("sync.call", 200, 100), span("stage.allreduce", 200, 50),
              launch(1, 5), kernel(1, 10, 20), launch(2, 6),
              kernel(2, 20, 20),                 # overlaps the first
              launch(3, 205), kernel(3, 210, 10)]
    rec = {"program": program.attribute(events)}
    # (30 + 10) us over two calls
    assert program.READERS["ring_ms.sync"](rec) == pytest.approx(0.020)
    assert program.READERS["pack_ms.sync"](rec) == 0.0


def test_idle_gaps_split_into_stages_and_between_them():
    events = [span("sync.call", 0, 100), span("stage.map.bucket_pack", 0, 30),
              span("stage.allreduce", 50, 35),
              launch(1, 1), kernel(1, 5, 15),     # 5..20
              launch(2, 2), kernel(2, 25, 10),    # 25..35
              launch(3, 51), kernel(3, 60, 10),   # 60..70
              launch(4, 52), kernel(4, 90, 5)]    # 90..95
    rec = {"program": program.attribute(events)}
    read = program.READERS
    # gaps: 20..25 (mid 22.5, in the pack), 35..60 (mid 47.5, between),
    # 70..90 (mid 80, in the ring stage)
    assert read["stage_idle_ms.sync"](rec) == pytest.approx(0.025)
    assert read["between_stages_idle_ms.sync"](rec) == pytest.approx(0.025)
    assert read["pack_ms.sync"](rec) == pytest.approx(0.025)
    assert read["ring_ms.sync"](rec) == pytest.approx(0.015)
    assert read["epilogue_ms.sync"](rec) == 0.0
    assert program.by_span(rec, program.SYNC_ROOT) == pytest.approx({
        "acis.stage.map.bucket_pack": [0.025, 0.005],
        "acis.sync.call": [0.0, 0.025],
        "acis.stage.allreduce": [0.015, 0.020]})


def test_readers_give_none_without_the_program():
    plain = {"window": {}, "trace": {"window_s": 1.0, "busy_s": 0.5,
                                     "ops": 10, "count": 1},
             "device_kind": H100}
    assert all(read(plain) is None for read in program.READERS.values())
    assert all(read({**plain, "program": None}) is None
               for read in program.READERS.values())


def test_kernel_rooflines_from_counters():
    _, bw = counts.peaks(H100)
    events = [launch(1, 0), kernel(1, 10, 10, "void (anonymous namespace)"
                                   "::hop_kernel<__nv_bfloat16, 0>(...)"),
              launch(2, 1), kernel(2, 30, 10, "void (anonymous namespace)"
                                   "::hop_kernel<float, 0>(...)"),
              launch(3, 2), kernel(3, 50, 100, "(anonymous namespace)"
                                   "::quant_hop_kernel(Hop)")]
    prog = program.attribute(events)
    prog["counters"] = {"kernel.fused_hop.bytes": bw * 10e-6,
                        "kernel.quant_hop.bytes": bw * 25e-6}
    rec = {"program": prog, "device_kind": H100}
    assert program.READERS["hop_roofline.sync"](rec) == pytest.approx(50.0)
    assert program.READERS["quant_hop_roofline.train"](rec) == \
        pytest.approx(25.0)
    prog["counters"] = {}
    assert program.READERS["hop_roofline.sync"](rec) is None


def test_second_pass_reads_the_programs_spans_on_the_cpu(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.obs import metrics

    def one_call(chrome):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with obs.spans.span("sync.call"):
                    with obs.spans.span("stage.allreduce"):
                        metrics.RECORDER.count("kernel.fused_hop.bytes", 12)
                        torch.ones(64).add_(1)
        prof.export_chrome_trace(str(chrome))
        return {"window_s": 1.0, "busy_s": 0.0, "ops": 0, "count": 2}

    got = program.second_pass(one_call, tmp_path / "x.program.trace.json")
    assert [(n, p) for n, _, _, p in got["spans"]] == [
        ("acis.sync.call", None), ("acis.stage.allreduce", 0),
        ("acis.sync.call", None), ("acis.stage.allreduce", 2)]
    assert got["counters"] == {"kernel.fused_hop.bytes": 24}
    assert got["pass"]["count"] == 2 and got["ops"] == []
    assert obs.current() is obs.null_recorder
    json.dumps(got)


def test_second_pass_of_a_program_without_spans(monkeypatch, tmp_path):
    from repro_torch.obs import spans

    monkeypatch.delattr(spans, "span")
    assert program.second_pass(lambda chrome: {}, tmp_path / "x") is None


@pytest.mark.cuda
def test_a_card_step_with_spans_does_not_synchronise():
    """A train step with the span log on calls ``torch.cuda.synchronize``
    zero times between its first and last span, and its forward plus
    backward device ms lie within 5% of CUDA events around
    ``local_grads`` on the same step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import configs, obs
    from repro_torch.core import make_engine
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import Model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as S

    dev = torch.device("cuda")
    cfg = configs.get("acis-100m")
    mesh = LocalMesh({"data": 8}, device=dev)
    eng = make_engine("acis")
    model, opt = Model(cfg), topt.adamw(1e-3)
    st = S.init_state(model, opt, torch.Generator(dev).manual_seed(0), eng,
                      mesh=mesh, arenas=True)
    toks = torch.randint(0, cfg.vocab, (32, 257), device=dev)
    step = S.build_train_step_acis(model, opt, mesh, eng)
    st, _ = step(st, {"tokens": toks})          # warm every shape
    torch.cuda.synchronize()

    real = torch.cuda.synchronize
    calls = []
    torch.cuda.synchronize = lambda *a, **k: (calls.append(1), real(*a, **k))
    try:
        with obs.recording(spans=True) as rec:
            st, _ = step(st, {"tokens": toks})
            during = len(calls)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            grads, metrics = S.local_grads(model, st, {"tokens": toks}, mesh)
            ev[1].record()
            st, _, _ = S.sync_and_update(eng, opt, st, grads, metrics, mesh)
    finally:
        torch.cuda.synchronize = real
    assert during == 0
    names = [s.name for s in rec.spans]
    assert names.count("train.step") == 1 and names.count("sync.call") == 2
    # local_grads called alone: its forward and backward are roots
    fb = sum(s.device_ms for s in rec.spans if s.parent is None
             and s.name in ("train.forward", "train.backward"))
    assert fb == pytest.approx(ev[0].elapsed_time(ev[1]), rel=0.05)
