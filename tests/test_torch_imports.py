"""repro_torch stands alone: no JAX, no reference package, no build at
import, and the card is the default device."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.mesh import LocalMesh

SRC = Path(repro_torch.__file__).resolve().parent.parent


def _all_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _import_all_in_a_fresh_process(report: str) -> str:
    mods = _all_modules()
    for m in ("cgra.mapper", "cgra.simulate", "configs.recurrentgemma_9b",
              "configs.rwkv6_1_6b", "core.compiler", "core.compression",
              "core.fused", "core.lookaside", "core.topology",
              "kernels.chunk_scan",
              "kernels.fused_combine", "kernels.pack_combine",
              "kernels.quant_combine", "kernels.rwkv6_recurrence",
              "kernels.topk_accum", "models.attention", "models.config",
              "models.decode", "models.layers", "models.model",
              "models.rglru", "models.rwkv6", "models.moe",
              "models.parallel", "configs.qwen3_8b", "configs.granite_8b",
              "configs.granite_3_8b", "configs.nemotron_4_15b",
              "configs.qwen2_moe_a2_7b", "serve.collectives",
              "models.transformer", "serve.engine", "obs.timeline",
              "obs.drift", "obs.report", "obs.__main__", "tune.trace",
              "tune.fit", "tune.replay", "tune.search",
              "elastic.membership", "elastic.sync", "data.pipeline",
              "train.loss", "train.optimizer", "train.step", "train.loop",
              "checkpoint.checkpoint", "sharding.rules", "sharding.act",
              "sharding.native", "train.pipeline", "launch.shapes",
              "launch.mesh", "launch.cells", "launch.dryrun",
              "roofline.analysis", "roofline.profile", "roofline.report"):
        assert "repro_torch." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        + report)
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_every_module_imports_without_jax_or_the_reference():
    got = _import_all_in_a_fresh_process(
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    assert got == "[]"


def test_importing_builds_and_loads_no_kernel():
    got = _import_all_in_a_fresh_process(
        "print(sys.modules['repro_torch.kernels.build']._LIBS)\n")
    assert got == "{}"


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    text = (SRC.parent / "chip_smoke.py").read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro")


def test_examples_import_neither_jax_nor_the_reference():
    """The port's entry points, ``examples/torch_*.py`` (one twin of each
    reference example), loaded in a fresh process: no JAX, no reference
    package."""
    twins = sorted((SRC.parent / "examples").glob("torch_*.py"))
    refs = sorted(p for p in (SRC.parent / "examples").glob("*.py")
                  if not p.name.startswith("torch_"))
    assert [p.name for p in twins] == ["torch_" + p.name for p in refs]
    code = (
        "import importlib.util, sys\n"
        f"for p in {[str(p) for p in twins]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_local_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalMesh({"data": 8})
    assert LocalMesh({"data": 8}, device="cpu").device.type == "cpu"


def test_local_mesh_rank_dims_and_transport():
    mesh = LocalMesh({"pod": 2, "data": 4}, device="cpu")
    assert mesh.rank_shape == (2, 4) and mesh.n_ranks == 8
    x = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    assert mesh.local_shape(x) == (3,)
    assert mesh.axis_index("data").shape == (1, 4)
    assert mesh.axis_index("pod").shape == (2, 1)
    # rank j sends to rank j + 1: rank r receives rank r - 1's value
    got = mesh.shift(x, "data", 1)
    assert torch.equal(got[:, 1], x[:, 0]) and torch.equal(got[:, 0],
                                                          x[:, 3])
    with pytest.raises(KeyError):
        mesh.axis_size("model")


def test_import_sets_up_mkl_vml_on_one_thread():
    """ROADMAP.md F4: importing the port runs every op torch computes
    through MKL's VML once, on one element, on the importing thread — so
    no VML function's first call comes from several OpenMP threads at
    once (the race behind F4)."""
    code = (
        "import torch\n"
        "from torch.profiler import ProfilerActivity, profile\n"
        "with profile(activities=[ProfilerActivity.CPU],\n"
        "             record_shapes=True) as prof:\n"
        "    import repro_torch\n"
        "seen = {(e.name, str(e.input_shapes)) for e in prof.events()}\n"
        "print(sorted(n for n, s in seen if s == '[[1]]'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    got = out.stdout.strip()
    for op in ("acos", "asin", "atan", "cos", "erf", "erfc", "erfinv", "exp",
               "log", "log10", "log2", "sin", "sqrt", "tan", "tanh", "trunc"):
        assert f"'aten::{op}'" in got, op


def test_set_up_covers_every_vml_op_of_this_torch():
    """The ops ``_set_up_vml`` runs are every op the installed torch binds
    to MKL's VML: the uncommented ``IMPLEMENT_VML_MKL(op, ...)`` lines of
    the ``ATen/cpu/vml.h`` it ships (each for float and double, the two
    dtypes set up).  A torch that binds another op fails here."""
    import re

    header = Path(torch.__file__).parent / "include" / "ATen" / "cpu" / \
        "vml.h"
    if not header.exists():
        pytest.skip("this torch ships no ATen headers")
    bound = set(re.findall(r"^IMPLEMENT_VML_MKL\((\w+),",
                           header.read_text(), re.M))
    assert "tanh" in bound
    assert {op.__name__ for op in repro_torch._VML_OPS} == bound
