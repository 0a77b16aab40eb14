"""repro_torch kernel wrappers and plain versions against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
plain version is held against the reference's Pallas kernel in interpret
mode, over the dtypes and ragged sizes of ``test_kernels_parity.py``.
add/max/min in every dtype and every pack are bitwise; ``mac`` is within
one rounding of the product and one of the result: XLA contracts f32
``x + alpha*y`` into one fused multiply-add and may keep the bf16 product
in f32 inside its fusion, where PyTorch (and the CUDA kernel) round after
each op.  The CUDA kernels themselves
run only on the card: the ``cuda`` cases skip here, and ``chip_smoke.py``
holds each kernel against its plain version there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import fused_combine as jfc
from repro.kernels import pack_combine as jpc
from repro.kernels import ref as jref
from repro_torch.core import switchops
from repro_torch.kernels import fused_combine as tfc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack_combine as tpc
from repro_torch.kernels import ref as tref

RAGGED = [1, 7, 129, 1000, 2048]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16),
          "int8": (np.int8, torch.int8, jnp.int8)}


@pytest.fixture
def cuda_device():
    # decided here, at run time, never at import or collection
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card (chip_smoke.py checks them there)")
    return torch.device("cuda")


def _data(rng, size, dt):
    if dt == "int8":
        return rng.integers(-100, 100, size=(size,)).astype(np.int8)
    return rng.standard_normal((size,)).astype(np.float32).astype(
        DTYPES[dt][0])


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want.astype(np.float32)) if want.dtype != np.int8 \
        else np.zeros(want.shape, bool)
    if want.dtype != np.int8:
        np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint8),
                                  want[~nan].view(np.uint8))


# ---------------------------------------------------------------------------
# fused_combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", RAGGED)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_combine_plain_matches_pallas(rng, op, dt, size):
    x, y = _data(rng, size, dt), _data(rng, size, dt)
    if dt != "int8" and op != "add" and size > 2:
        x[1] = np.nan                       # NaN propagates through max/min
        y[2] = np.nan
    want = np.asarray(jfc.fused_combine(jnp.asarray(x), jnp.asarray(y),
                                        op=op, interpret=True))
    got = tfc.fused_combine(_torch(x), _torch(y), op=op)
    assert_bitwise(_numpy(got), want)


@pytest.mark.parametrize("size", RAGGED)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mac_plain_matches_pallas(rng, dt, size):
    x, y = _data(rng, size, dt), _data(rng, size, dt)
    want = np.asarray(jfc.fused_combine(jnp.asarray(x), jnp.asarray(y),
                                        op="mac", alpha=0.3, interpret=True))
    got = _numpy(tfc.fused_combine(_torch(x), _torch(y), op="mac",
                                   alpha=0.3))
    # the reference's XLA contracts x + alpha*y into one FMA (f32) or keeps
    # the product in f32 (bf16); the two-op version rounds the product
    # first.  They differ by at most one rounding of the product plus one
    # of the result: an ulp of each, in the operands' dtype
    g, w = got.astype(np.float32), want.astype(np.float32)
    prod = np.abs(np.float32(0.3) * y.astype(np.float32))
    tol = np.spacing(np.abs(w).astype(got.dtype)).astype(np.float32) \
        + np.spacing(prod.astype(got.dtype)).astype(np.float32)
    assert np.all(np.abs(g - w) <= tol)


def test_int8_add_wraps(rng):
    x = np.array([127, -128, 100, -100], np.int8)
    y = np.array([1, -1, 100, -100], np.int8)
    got = tfc.fused_combine(_torch(x), _torch(y), op="add").numpy()
    want = np.asarray(jfc.fused_combine(jnp.asarray(x), jnp.asarray(y),
                                        interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-128, 127, -56, 56])


def test_combine_wrapper_rejects_bad_operands():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="shape"):
        tfc.fused_combine(a, torch.zeros(9))
    with pytest.raises(TypeError, match="dtype"):
        tfc.fused_combine(a, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown combine op"):
        tfc.fused_combine(a, a, op="prod")
    with pytest.raises(ValueError, match="CUDA"):
        tfc.fused_combine(a.to("meta"), a.to("meta"))


def test_cpu_combine_takes_the_plain_version_and_launches_nothing(rng):
    before = tfc.launches
    x = _torch(_data(rng, 33, "float32"))
    got = tops.combine_add(x, x)
    assert torch.equal(got, x + x)
    assert tfc.launches == before


# ---------------------------------------------------------------------------
# fused_pack
# ---------------------------------------------------------------------------

def _pack_case(rng, size, dt, n_parts=3):
    arena = _data(rng, size + 5, dt)           # 5 tail lanes must survive
    cuts = sorted(set(rng.integers(1, size, size=n_parts - 1).tolist())) \
        if size > 1 else []
    parts, lo = [], 0
    for hi in cuts + [size]:
        if hi > lo:
            parts.append(_data(rng, hi - lo, dt))
            lo = hi
    return arena, parts


@pytest.mark.parametrize("size", RAGGED)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op", [None, "add", "max", "min"])
def test_pack_plain_matches_pallas(rng, op, dt, size):
    arena, parts = _pack_case(rng, size, dt)
    want = np.asarray(jpc.fused_pack(jnp.asarray(arena),
                                     *[jnp.asarray(p) for p in parts],
                                     op=op, interpret=True))
    ta = _torch(arena)
    ptr = ta.data_ptr()
    got = tpc.fused_pack(ta, *[_torch(p) for p in parts], op=op)
    assert got is ta and got.data_ptr() == ptr       # written in place
    assert_bitwise(_numpy(got), want)
    assert_bitwise(_numpy(got)[size:], arena[size:])  # the tail survives


def test_pack_rank_rows_match_per_rank_pallas(rng):
    """Rank dims fold into rows: each row packs exactly as the reference
    packs that rank's arena."""
    rows, sizes = 8, [5, 0, 17, 2]
    arena = rng.standard_normal((rows, 30)).astype(np.float32)
    parts = [rng.standard_normal((rows, s)).astype(np.float32)
             for s in sizes]
    got = tpc.fused_pack(torch.from_numpy(arena.copy()),
                         *[torch.from_numpy(p) for p in parts], op="add")
    for r in range(rows):
        # (the Pallas interpreter cannot block a zero-size part; an empty
        # part writes nothing, so leaving it out is the same pack)
        want = jpc.fused_pack(jnp.asarray(arena[r]),
                              *[jnp.asarray(p[r]) for p in parts
                                if p.shape[1]], op="add", interpret=True)
        assert_bitwise(got[r].numpy(), np.asarray(want))


def test_pack_overflow_raises_before_writing():
    arena = torch.arange(10, dtype=torch.float32)
    with pytest.raises(ValueError, match="overflows arena"):
        tpc.fused_pack(arena, torch.ones(6), torch.ones(5))
    assert torch.equal(arena, torch.arange(10, dtype=torch.float32))


def test_pack_wrapper_rejects_bad_parts():
    arena = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="expected"):
        tpc.fused_pack(arena, torch.ones(3, 2))
    with pytest.raises(TypeError, match="cast the parts"):
        tpc.fused_pack(arena, torch.ones(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown pack op"):
        tpc.fused_pack(arena, torch.ones(4, 2), op="prod")
    assert tpc.fused_pack(arena) is arena


# ---------------------------------------------------------------------------
# the registry: use_kernel routes through the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["add", "max", "min", "mac"])
def test_registry_kernel_and_plain_agree_on_cpu(rng, name):
    switchops.load_kernels()
    x = _torch(_data(rng, 257, "float32"))
    y = _torch(_data(rng, 257, "float32"))
    op = switchops.get(name)
    assert op.kernel is not None
    assert torch.equal(op(x, y, use_kernel=True), op(x, y))


def test_registry_pack_kernel_is_in_place():
    switchops.load_kernels()
    arena = torch.zeros(2, 6)
    out = switchops.get("pack_combine")(arena, torch.ones(2, 4),
                                        use_kernel=True)
    assert out is arena and float(arena.sum()) == 8.0


# ---------------------------------------------------------------------------
# every plain version of kernels/ref.py against the reference oracle
# ---------------------------------------------------------------------------

def test_ref_quant_combine_matches_reference(rng):
    qa = rng.integers(-127, 128, size=(6, 256)).astype(np.int8)
    qb = rng.integers(-127, 128, size=(6, 256)).astype(np.int8)
    sa = np.abs(rng.standard_normal(6)).astype(np.float32)
    sb = np.abs(rng.standard_normal(6)).astype(np.float32)
    sa[0] = sb[0] = 0.0                       # an all-zero row: scale 1
    wq, ws = jref.quant_combine(*map(jnp.asarray, (qa, sa, qb, sb)))
    tq, ts = tref.quant_combine(*map(torch.from_numpy, (qa, sa, qb, sb)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    # XLA may fuse q*s + q*s into one FMA: a lane can requantize one step
    # away from PyTorch's two-rounding result
    assert np.abs(tq.numpy().astype(int) - np.asarray(wq).astype(int)
                  ).max() <= 1


def test_ref_topk_accumulate_matches_reference(rng):
    dense = rng.standard_normal(50).astype(np.float32)
    idx = np.array([3, 3, 7, 49, 0, 3], np.int32)    # duplicates accumulate
    vals = rng.standard_normal(6).astype(np.float32)
    want = jref.topk_accumulate(*map(jnp.asarray, (dense, idx, vals)))
    got = tref.topk_accumulate(*map(torch.from_numpy, (dense, idx, vals)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(37,), (20, 3)])
def test_ref_prefix_sum_matches_reference(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(tref.prefix_sum(torch.from_numpy(x)).numpy(),
                               np.asarray(jref.prefix_sum(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_ref_rglru_scan_matches_reference(rng):
    a = rng.uniform(0.5, 1.0, (16, 4)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    want = jref.rglru_scan(jnp.asarray(a), jnp.asarray(b))
    got = tref.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_ref_rwkv6_recurrence_matches_reference(rng):
    T, K, V = 9, 4, 5
    r, k, w = (rng.standard_normal((T, K)).astype(np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-w))
    v = rng.standard_normal((T, V)).astype(np.float32)
    u = rng.standard_normal(K).astype(np.float32)
    wo, ws = jref.rwkv6_recurrence(*map(jnp.asarray, (r, k, v, w, u)))
    to, ts = tref.rwkv6_recurrence(*map(torch.from_numpy, (r, k, v, w, u)))
    np.testing.assert_allclose(to.numpy(), np.asarray(wo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# on the card (skipped on hosts without CUDA; chip_smoke.py runs these
# checks at the main path's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max", "min", "mac"])
def test_combine_kernel_matches_plain_on_card(cuda_device, op):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(65539, device=cuda_device, generator=g)
    y = torch.randn(65539, device=cuda_device, generator=g)
    before = tfc.launches
    got = tfc.fused_combine(x, y, op=op, alpha=0.5)
    assert tfc.launches == before + 1
    assert torch.equal(got, tfc.plain(x, y, op, 0.5))


@pytest.mark.cuda
def test_pack_kernel_matches_plain_on_card(cuda_device):
    arena = torch.randn(8, 100, device=cuda_device)
    parts = [torch.randn(8, s, device=cuda_device) for s in (7, 40, 33)]
    want = tpc.plain(arena.clone(), *parts, op="max")
    ptr = arena.data_ptr()
    got = tpc.fused_pack(arena, *parts, op="max")
    assert got.data_ptr() == ptr and torch.equal(got, want)
