"""The ring all-gather kernel (``fused_gather`` in
``kernels/fused_combine.py``) on the card, against the ring's shift and put
loop it replaces (``core.ring._ring_all_gather_loop``), bit for bit: it
copies bytes, so nothing may differ.  The CPU cases, the kernel's plain
version against the same loop, are in ``test_torch_ring.py``.

Every case here carries the ``cuda`` mark and skips without a card.  No
JAX is imported, so on the card run the file with ``--noconftest``.
"""

import math

import pytest
import torch

from repro_torch import core as acis
from repro_torch import tree
from repro_torch.configs.acis_100m import SMOKE, grad_leaf_specs
from repro_torch.core import ring
from repro_torch.kernels import fused_combine as fc
from repro_torch.mesh import LocalMesh, current


@pytest.fixture
def cuda_device():
    # decided here, at run time, never at import or collection
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gather kernel runs only on the "
                    "card")
    return torch.device("cuda")


# the whisper-small sync's largest and smallest ring all-gathers on
# {"data": 8}, then segments off the 16-byte grid: 8 x 1,001 int8 bytes a
# rank's result, and 2,006-byte rows on the outer axis of two
GATHER_CARD_CASES = [({"data": 8}, "data", (4_979_040,), torch.bfloat16),
                     ({"data": 8}, "data", (11_904,), torch.float32),
                     ({"data": 8}, "data", (1001,), torch.int8),
                     ({"pod": 2, "data": 4}, "pod", (1003,), torch.bfloat16),
                     ({"pod": 2, "data": 4}, "data", (3, 5), torch.float32)]


def _card_chunks(dev, shape, dtype, offset=0):
    """Random ``shape`` in ``dtype`` on the card, ``offset`` elements into
    its allocation (off the 16-byte grid when ``offset`` is odd)."""
    g = torch.Generator(device=dev).manual_seed(0)
    numel = math.prod(shape) + offset
    if dtype == torch.int8:
        flat = torch.randint(-128, 128, (numel,), device=dev, generator=g,
                             dtype=torch.int8)
    else:
        flat = torch.randn(numel, device=dev, generator=g).to(dtype)
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("axes,axis,chunk,dtype", GATHER_CARD_CASES)
def test_gather_kernel_is_the_ring_loop_on_card(cuda_device, axes, axis,
                                                chunk, dtype, offset):
    """One launch, bit for bit the ring's shift + put loop on the card,
    whether the chunks lie on the 16-byte grid or not."""
    mesh = LocalMesh(axes, device=cuda_device)
    first = _card_chunks(cuda_device, mesh.rank_shape + chunk, dtype, offset)
    with mesh:
        want = ring._ring_all_gather_loop(first, axis)
    before = fc.gather_launches
    got = fc.fused_gather(first, dim=mesh.dim(axis),
                          rank_ndim=mesh.rank_ndim)
    assert fc.gather_launches == before + 1
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _loop_gather(first, *, dim, rank_ndim):
    """The ring loop in the gather kernel's place."""
    return ring._ring_all_gather_loop(first, current().axis_names[dim])


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kw", [
    ("acis", {}), ("acis_compressed", {"compressor": "int8"}),
    ("acis_compressed", {"compressor": "int8_hopquant"})])
def test_sync_with_the_gather_kernel_is_the_loop_path_on_card(
        cuda_device, monkeypatch, backend, kw):
    """A whole sync of the smoke tree on {"data": 8}, its all-gathers
    launched, bit for bit the sync with the ring loop in their place (the
    int8 wires' blocks, int16 sums and f32 scales among them);
    ``gather_launches`` rises by one for each all-gather the loop ran."""
    mesh = LocalMesh({"data": 8}, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    grads = {k: torch.randn(mesh.rank_shape + shape, device=cuda_device,
                            generator=g).to(dt)
             for k, shape, dt in grad_leaf_specs(SMOKE)}
    eng = acis.make_engine(backend, **kw)
    state = eng.init_state(grads)
    before = fc.gather_launches
    got = eng.gradient_sync(grads, state, mesh=mesh)
    launched = fc.gather_launches - before
    loops = []
    loop = ring._ring_all_gather_loop
    monkeypatch.setattr(ring, "_ring_all_gather_loop",
                        lambda *a: loops.append(1) or loop(*a))
    monkeypatch.setattr(fc, "fused_gather", _loop_gather)
    want = eng.gradient_sync(grads, state, mesh=mesh)
    assert launched == len(loops) > 0
    for a, b in zip(tree.tree_leaves(got), tree.tree_leaves(want)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
