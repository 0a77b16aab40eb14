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
    for m in ("cgra.mapper", "configs.recurrentgemma_9b",
              "configs.rwkv6_1_6b", "core.compiler", "core.compression",
              "core.fused", "core.lookaside", "core.topology",
              "kernels.chunk_scan",
              "kernels.fused_combine", "kernels.pack_combine",
              "kernels.quant_combine", "kernels.rwkv6_recurrence",
              "kernels.topk_accum", "models.attention", "models.config",
              "models.decode", "models.layers", "models.model",
              "models.rglru", "models.rwkv6",
              "models.transformer", "serve.engine"):
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
