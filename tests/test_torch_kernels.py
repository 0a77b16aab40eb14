"""repro_torch kernel wrappers and plain versions against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
plain version is held against the reference's Pallas kernel in interpret
mode, over the dtypes and ragged sizes of ``test_kernels_parity.py``.
add/max/min in every dtype and every pack are bitwise; ``mac`` is within
one rounding of the product and one of the result: XLA contracts f32
``x + alpha*y`` into one fused multiply-add and may keep the bf16 product
in f32 inside its fusion, where PyTorch (and the CUDA kernel) round after
each op.  ``quant_combine`` meets the same contraction in ``q·s + q·s``:
bitwise where the products are exact (the .5 ties, zero rows and
saturation cases), within one int8 step elsewhere.  ``topk_accumulate`` is
bitwise with distinct indices and within f32 rounding of the sum with
duplicates, whose order differs.  The CUDA kernels themselves
run only on the card: the ``cuda`` cases skip here, and ``chip_smoke.py``
holds each kernel against its plain version there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import chunk_scan as jcs
from repro.kernels import fused_combine as jfc
from repro.kernels import pack_combine as jpc
from repro.kernels import quant_combine as jqc
from repro.kernels import ref as jref
from repro.kernels import topk_accum as jta
from repro_torch.core import switchops
from repro_torch.core.compression import sparse_accumulate
from repro_torch.kernels import chunk_scan as tcs
from repro_torch.kernels import fused_combine as tfc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack_combine as tpc
from repro_torch.kernels import quant_combine as tqc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_recurrence as trw
from repro_torch.kernels import topk_accum as tta

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


def test_cpu_combine_path_loads_nothing_and_launches_nothing(rng,
                                                             monkeypatch):
    """The CPU path returns before the library, its argtypes and the
    cached alpha: nothing is built, typed or launched, ``mac`` included."""
    def no_build(name):
        raise AssertionError(f"the CPU path loaded {name}")
    monkeypatch.setattr(tfc.build, "library", no_build)
    monkeypatch.setattr(tfc, "_LIB", None)
    tfc._alpha.cache_clear()
    before = (tfc.launches, tfc.hop_launches)
    x = _torch(_data(rng, 33, "float32"))
    for op in ("add", "max", "min", "mac"):
        assert torch.equal(tfc.fused_combine(x, x, op=op, alpha=0.3),
                           tfc.plain(x, x, op, 0.3))
    xs = torch.arange(96, dtype=torch.float32).reshape(2, 4, 4, 3)
    tfc.fused_hop(xs[:, :, 0], xs, 1, dim=1, rank_ndim=2, op="max")
    assert (tfc.launches, tfc.hop_launches) == before
    assert tfc._LIB is None and tfc._alpha.cache_info().currsize == 0


@pytest.mark.parametrize("axes,dim", [((8,), 0), ((2, 4), 1), ((4, 2), 0),
                                      ((2, 3, 2), 1)])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_ring_hop_plain_is_the_transport_step(rng, axes, dim, op):
    """``fused_hop``'s plain version equals the step the ring takes
    through the transport, ``combine(shift(buf, 1), take(xs, (i - 2 - s)
    % n))``, for every hop ``s`` and a ring over any rank dim."""
    from repro_torch.mesh import LocalMesh

    names = [f"a{k}" for k in range(len(axes))]
    mesh = LocalMesh(dict(zip(names, axes)), device="cpu")
    n = axes[dim]
    xs = torch.from_numpy(rng.standard_normal(axes + (n, 5, 3)).astype(
        np.float32))
    buf = torch.from_numpy(rng.standard_normal(axes + (5, 3)).astype(
        np.float32))
    i = mesh.axis_index(names[dim])
    for s in range(n - 1):
        want = tref.COMBINES[op](mesh.shift(buf, names[dim], 1),
                                 mesh.take(xs, (i - 2 - s) % n))
        got = tfc.fused_hop(buf, xs, s, dim=dim, rank_ndim=len(axes), op=op)
        assert_bitwise(_numpy(got), _numpy(want))


def test_hop_wrapper_rejects_bad_operands():
    xs, buf = torch.zeros(8, 8, 4), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="unknown hop op"):
        tfc.fused_hop(buf, xs, 0, dim=0, rank_ndim=1, op="mac")
    with pytest.raises(ValueError, match="ring chunks"):
        tfc.fused_hop(buf, xs[:, :4], 0, dim=0, rank_ndim=1)
    with pytest.raises(ValueError, match="hop 7"):
        tfc.fused_hop(buf, xs, 7, dim=0, rank_ndim=1)
    with pytest.raises(ValueError, match="rank dims"):
        tfc.fused_hop(buf, xs, 0, dim=1, rank_ndim=1)
    with pytest.raises(TypeError, match="dtype"):
        tfc.fused_hop(buf, xs.double(), 0, dim=0, rank_ndim=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.fused_hop(buf.to("meta"), xs.to("meta"), 0, dim=0, rank_ndim=1)


# ---------------------------------------------------------------------------
# fused_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("n_parts", [1, 3, 96, 97, 250])
def test_pack_plan_splits_launches_and_covers_every_column_once(
        rng, itemsize, n_parts):
    """The launches' by-value tables: parts of size 0 left out, at most
    MAX_PARTS per launch, every segment at its prefix offset, and the
    blocks (a part by the tile prefix, then its tile's columns) cover
    every column of every part exactly once."""
    sizes = rng.integers(0, 3000, size=n_parts).tolist()
    sizes[0] = 0 if n_parts > 1 else 5
    ptrs = [4096 * (k + 1) for k in range(n_parts)]
    tile = tpc.tile_elems(itemsize)
    plan = tpc.pack_plan(ptrs, sizes, itemsize)
    live = [k for k, s in enumerate(sizes) if s]
    assert len(plan) == -(-len(live) // tpc.MAX_PARTS)
    covered = np.zeros(sum(sizes) + 7, np.int64)
    seen = []
    for src, offset, size, tile0 in plan:
        assert 1 <= len(src) <= tpc.MAX_PARTS
        assert len(offset) == len(size) == len(src) == len(tile0) - 1
        for block in range(tile0[-1]):
            j = max(k for k in range(len(src)) if tile0[k] <= block)
            t = block - tile0[j]
            covered[offset[j] + t * tile:
                    offset[j] + min(size[j], (t + 1) * tile)] += 1
        seen += list(zip(src, offset, size))
    assert seen == [(ptrs[k], sum(sizes[:k]), sizes[k]) for k in live]
    want = np.zeros_like(covered)
    want[:sum(sizes)] = 1
    np.testing.assert_array_equal(covered, want)


def test_cpu_pack_loads_nothing_and_launches_nothing(rng, monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded {name}")
    monkeypatch.setattr(tpc.build, "library", no_build)
    monkeypatch.setattr(tpc, "_LIB", None)
    before = tpc.launches
    arena = torch.zeros(8, 300)
    parts = [torch.ones(8, 2)] * 120        # more parts than one launch
    assert tpc.fused_pack(arena, *parts) is arena
    assert float(arena.sum()) == 8 * 240
    assert tpc.launches == before and tpc._LIB is None

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
# quant_combine
# ---------------------------------------------------------------------------

def quant_cases(rng):
    """(qa, sa, qb, sb) rows with exact products: .5 ties, an all-zero
    row, zero scales, and ±127 saturation."""
    rows = 6
    qa = rng.integers(-127, 128, size=(rows, 256)).astype(np.int8)
    qb = rng.integers(-127, 128, size=(rows, 256)).astype(np.int8)
    sa = np.full(rows, 0.5, np.float32)
    sb = np.full(rows, 0.5, np.float32)
    # row 0: |acc| peaks at 127 (scale 1.0); qa + qb odd lanes are .5 ties
    qa[0], qb[0] = rng.integers(-60, 61, size=(2, 256)).astype(np.int8)
    qa[0, 0] = qb[0, 0] = 127
    qa[0, 1:7] = [1, 2, 3, -1, -2, -3]
    qb[0, 1:7] = [0, 1, 2, 0, -1, -2]              # ±0.5, ±1.5, ±2.5
    qa[1] = qb[1] = 0                              # all-zero row
    sa[2] = sb[2] = 0.0                            # zero scales
    qa[3] = qb[3] = 127                            # saturates at 127
    qa[4] = qb[4] = -127                           # and at -127
    sa[5], sb[5] = 2.0, 0.25
    return qa, sa, qb, sb


def test_quant_combine_plain_matches_pallas_bitwise_on_exact_rows(rng):
    qa, sa, qb, sb = quant_cases(rng)
    wq, ws = jqc.quant_combine(*map(jnp.asarray, (qa, sa, qb, sb)),
                               interpret=True)
    tq, ts = tqc.quant_combine(*map(torch.from_numpy, (qa, sa, qb, sb)))
    assert_bitwise(tq.numpy(), np.asarray(wq))
    assert_bitwise(ts.numpy(), np.asarray(ws))
    assert tq.numpy()[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]  # half even
    assert ts.numpy()[1] == ts.numpy()[2] == 1.0
    assert (tq.numpy()[1:3] == 0).all()
    assert (tq.numpy()[3] == 127).all() and (tq.numpy()[4] == -127).all()


@pytest.mark.parametrize("rows", [1, 9, 70])
def test_quant_combine_plain_matches_pallas_on_random_rows(rng, rows):
    qa = rng.integers(-127, 128, size=(rows, 256)).astype(np.int8)
    qb = rng.integers(-127, 128, size=(rows, 256)).astype(np.int8)
    sa = np.abs(rng.standard_normal(rows)).astype(np.float32)
    sb = np.abs(rng.standard_normal(rows)).astype(np.float32)
    wq, ws = jqc.quant_combine(*map(jnp.asarray, (qa, sa, qb, sb)),
                               interpret=True)
    tq, ts = tqc.quant_combine(*map(torch.from_numpy, (qa, sa, qb, sb)))
    # XLA may contract q*s + q*s into one FMA: the sums, hence the
    # scales, agree to an ulp, and a lane can requantize one step away
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=2e-7)
    assert np.abs(tq.numpy().astype(int)
                  - np.asarray(wq).astype(int)).max() <= 1


def test_quant_combine_folds_rank_dims_into_rows(rng):
    """The ring's chunk [*rank, blocks, 256]: each rank's rows combine as
    the reference combines that rank's payload."""
    qa, sa, qb, sb = (np.stack([c] * 2) for c in quant_cases(rng))
    tq, ts = tqc.quant_combine(*map(torch.from_numpy, (qa, sa, qb, sb)))
    assert tuple(tq.shape) == (2, 6, 256) and tuple(ts.shape) == (2, 6)
    for r in range(2):
        wq, ws = jqc.quant_combine(*map(jnp.asarray,
                                        (qa[r], sa[r], qb[r], sb[r])),
                                   interpret=True)
        assert_bitwise(tq[r].numpy(), np.asarray(wq))
        assert_bitwise(ts[r].numpy(), np.asarray(ws))


def test_quant_combine_wrapper_rejects_bad_operands():
    q, s = torch.zeros(3, 256, dtype=torch.int8), torch.ones(3)
    with pytest.raises(ValueError, match="payloads"):
        tqc.quant_combine(torch.zeros(3, 128, dtype=torch.int8),
                          torch.ones(3), q, s)
    with pytest.raises(ValueError, match="scales"):
        tqc.quant_combine(q, torch.ones(4), q, s)
    with pytest.raises(TypeError, match="int8 payloads"):
        tqc.quant_combine(q.float(), s, q, s)
    with pytest.raises(ValueError, match="CUDA"):
        tqc.quant_combine(q.to("meta"), s.to("meta"), q.to("meta"),
                          s.to("meta"))


def test_cpu_quant_combine_takes_the_plain_version(rng):
    before = tqc.launches
    qa, sa, qb, sb = map(torch.from_numpy, quant_cases(rng))
    got = tqc.quant_combine(qa, sa, qb, sb)
    want = tref.quant_combine(qa, sa, qb, sb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tqc.launches == before


def _hop_operands(qa, sa, qb, sb, rank_shape, n):
    """Every rank's partial sum holds (qa, sa) and every chunk (qb, sb)."""
    def rep(t, extra):
        return torch.from_numpy(t).expand(rank_shape + extra + t.shape) \
            .contiguous()
    return rep(qa, ()), rep(sa, ()), rep(qb, (n,)), rep(sb, (n,))


@pytest.mark.parametrize("rank_shape,dim", [((8,), 0), ((2, 4), 1)])
def test_quant_hop_plain_matches_pallas_on_exact_rows(rng, rank_shape, dim):
    """With the exact rows of :func:`quant_cases` in every rank's partial
    sum and chunk, each output row of every hop is the reference kernel's
    combine of those rows, bit for bit."""
    qa, sa, qb, sb = quant_cases(rng)
    wq, ws = jqc.quant_combine(*map(jnp.asarray, (qa, sa, qb, sb)),
                               interpret=True)
    n = rank_shape[dim]
    ops = _hop_operands(qa, sa, qb, sb, rank_shape, n)
    for s in range(n - 1):
        q, sc = tqc.hop_plain(*ops, s, dim=dim, rank_ndim=len(rank_shape))
        assert tuple(q.shape) == rank_shape + (6, 256)
        for r in np.ndindex(*rank_shape):
            assert_bitwise(q[r].numpy(), np.asarray(wq))
            assert_bitwise(sc[r].numpy(), np.asarray(ws))


def test_quant_hop_wrapper_rejects_bad_operands():
    q_buf, s_buf = torch.zeros(8, 3, 256, dtype=torch.int8), torch.ones(8, 3)
    q_xs = torch.zeros(8, 8, 3, 256, dtype=torch.int8)
    s_xs = torch.ones(8, 8, 3)
    with pytest.raises(ValueError, match="rank dims"):
        tqc.quant_hop(q_buf, s_buf, q_xs, s_xs, 0, dim=1, rank_ndim=1)
    with pytest.raises(ValueError, match="buf must be"):
        tqc.quant_hop(q_buf[..., :128], s_buf, q_xs, s_xs, 0, dim=0,
                      rank_ndim=1)
    with pytest.raises(ValueError, match="ring chunks"):
        tqc.quant_hop(q_buf, s_buf, q_xs[:, :4], s_xs[:, :4], 0, dim=0,
                      rank_ndim=1)
    with pytest.raises(ValueError, match="hop 7"):
        tqc.quant_hop(q_buf, s_buf, q_xs, s_xs, 7, dim=0, rank_ndim=1)
    with pytest.raises(TypeError, match="int8 payloads"):
        tqc.quant_hop(q_buf.float(), s_buf, q_xs, s_xs, 0, dim=0,
                      rank_ndim=1)
    with pytest.raises(TypeError, match="float32 scales"):
        tqc.quant_hop(q_buf, s_buf, q_xs, s_xs.double(), 0, dim=0,
                      rank_ndim=1)
    with pytest.raises(ValueError, match="CUDA"):
        tqc.quant_hop(*(t.to("meta") for t in (q_buf, s_buf, q_xs, s_xs)),
                      0, dim=0, rank_ndim=1)


def test_cpu_quant_kernels_load_nothing_and_launch_nothing(rng,
                                                           monkeypatch):
    """Both forms on CPU tensors run their plain versions: no library is
    built or loaded and neither count moves."""
    def no_build(name):
        raise AssertionError(f"a CPU call loaded the {name} library")
    monkeypatch.setattr(tqc.build, "library", no_build)
    monkeypatch.setattr(tqc, "_LIB", None)
    before = (tqc.launches, tqc.hop_launches)
    qa, sa, qb, sb = quant_cases(rng)
    tqc.quant_combine(*map(torch.from_numpy, (qa, sa, qb, sb)))
    ops = _hop_operands(qa, sa, qb, sb, (8,), 8)
    tqc.quant_hop(*ops, 3, dim=0, rank_ndim=1)
    assert (tqc.launches, tqc.hop_launches) == before
    assert tqc._LIB is None


# ---------------------------------------------------------------------------
# topk_accumulate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k", [(50, 6), (3000, 64), (5000, 1)])
def test_topk_accumulate_plain_matches_pallas_distinct(rng, size, k):
    dense = rng.standard_normal(size).astype(np.float32)
    idx = rng.choice(size, size=k, replace=False).astype(np.int32)
    vals = rng.standard_normal(k).astype(np.float32)
    want = jta.topk_accumulate(*map(jnp.asarray, (dense, idx, vals)),
                               interpret=True)
    got = tta.topk_accumulate_(*map(torch.from_numpy,
                                    (dense.copy(), idx, vals)))
    assert_bitwise(got.numpy(), np.asarray(want))


def test_topk_accumulate_plain_matches_pallas_duplicates(rng):
    """Duplicates accumulate; the sum's order differs (one-hot matmul vs
    index_add), so a lane agrees to f32 rounding: d·2^-23·Σ|v| for d
    adds."""
    dense = rng.standard_normal(300).astype(np.float32)
    idx = np.array([3, 3, 7, 299, 0, 3, 7, 3], np.int32)
    vals = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jta.topk_accumulate(
        *map(jnp.asarray, (dense, idx, vals)), interpret=True))
    got = tta.topk_accumulate_(*map(torch.from_numpy,
                                    (dense.copy(), idx, vals)))
    tol = 5 * 2.0 ** -23 * (np.abs(vals).sum() + np.abs(dense).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_topk_accumulate_drops_out_of_range_indices(rng):
    dense = rng.standard_normal(40).astype(np.float32)
    idx = np.array([-1, 5, 40, 1000, 39], np.int32)
    vals = rng.standard_normal(5).astype(np.float32)
    want = jta.topk_accumulate(*map(jnp.asarray, (dense, idx, vals)),
                               interpret=True)
    got = tta.topk_accumulate_(*map(torch.from_numpy,
                                    (dense.copy(), idx, vals)))
    assert_bitwise(got.numpy(), np.asarray(want))
    assert_bitwise(got.numpy()[[0, 1, 2, 3, 4, 6, 38]],
                   dense[[0, 1, 2, 3, 4, 6, 38]])


def test_topk_accumulate_spread_duplicates_and_out_of_range(rng):
    """A payload over a row's whole range, as chip_smoke.py's card check
    draws it at size: duplicates far apart and out-of-range indices among
    them, k not a multiple of 4.  Dropped lanes agree bit for bit; the rest
    to f32 rounding of each lane's d adds, d·2^-23·(|dense| + Σ|vals|)."""
    size, k = 5000, 403
    dense = rng.standard_normal(size).astype(np.float32)
    idx = rng.integers(0, size, k).astype(np.int32)
    idx[1::37] = idx[0]
    idx[2::41] = np.array([-1, size, 1 << 30, -(1 << 31)] * 3,
                          np.int32)[:len(idx[2::41])]
    vals = rng.standard_normal(k).astype(np.float32)
    want = np.asarray(jta.topk_accumulate(
        *map(jnp.asarray, (dense, idx, vals)), interpret=True))
    got = tta.topk_accumulate_(*map(torch.from_numpy,
                                    (dense.copy(), idx, vals))).numpy()
    keep = (idx >= 0) & (idx < size)
    mult = np.bincount(idx[keep], minlength=size)
    absum = np.abs(dense).copy()
    np.add.at(absum, idx[keep], np.abs(vals[keep]))
    assert np.all(np.abs(got - want) <= mult * 2.0 ** -23 * absum)
    untouched = mult == 0
    assert_bitwise(got[untouched], dense[untouched])


def test_topk_accumulate_rows_in_place(rng):
    """Rank dims fold into rows: row r adds into dense[r], in place."""
    dense = rng.standard_normal((4, 2, 70)).astype(np.float32)
    idx = np.stack([rng.choice(70, size=9, replace=False)
                    for _ in range(8)]).reshape(4, 2, 9).astype(np.int32)
    vals = rng.standard_normal((4, 2, 9)).astype(np.float32)
    td = torch.from_numpy(dense.copy())
    ptr = td.data_ptr()
    out = tta.topk_accumulate_(td, torch.from_numpy(idx),
                               torch.from_numpy(vals))
    assert out is td and td.data_ptr() == ptr
    for a in range(4):
        for b in range(2):
            want = jta.topk_accumulate(
                *map(jnp.asarray, (dense[a, b], idx[a, b], vals[a, b])),
                interpret=True)
            assert_bitwise(td[a, b].numpy(), np.asarray(want))


def test_topk_accumulate_functional_form_leaves_dense(rng):
    """The functional form is ``compression.sparse_accumulate``; the
    registry's kernel binding is in place."""
    d = torch.zeros(10)
    got = sparse_accumulate(d, torch.tensor([1, 2], dtype=torch.int32),
                            torch.tensor([1.0, 2.0]), use_kernels=True)
    assert float(d.abs().sum()) == 0.0 and float(got.sum()) == 3.0
    assert tops.topk_accumulate(d, torch.tensor([1], dtype=torch.int32),
                                torch.tensor([4.0])) is d
    assert float(d.sum()) == 4.0


def test_topk_accumulate_wrapper_rejects_bad_operands():
    d = torch.zeros(4, 10)
    i = torch.zeros(4, 3, dtype=torch.int32)
    v = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="rows"):
        tta.topk_accumulate_(d, i[:3], v[:3])
    with pytest.raises(TypeError, match="integers"):
        tta.topk_accumulate_(d, v, v)
    with pytest.raises(TypeError, match="cast the values"):
        tta.topk_accumulate_(d, i, v.double())
    with pytest.raises(ValueError, match="contiguous"):
        tta.topk_accumulate_(torch.zeros(10, 4).T, i, v)
    with pytest.raises(ValueError, match="CUDA"):
        tta.topk_accumulate_(d.to("meta"), i.to("meta"), v.to("meta"))


def test_cpu_topk_accumulate_launches_nothing():
    before = tta.launches
    tta.topk_accumulate_(torch.zeros(3, 8),
                         torch.ones(3, 2, dtype=torch.int32),
                         torch.ones(3, 2))
    assert tta.launches == before


# ---------------------------------------------------------------------------
# the registry: use_kernel routes through the wrappers
# ---------------------------------------------------------------------------

def test_registry_topk_accumulate_kernel_agrees_on_cpu(rng):
    switchops.load_kernels()
    op = switchops.get("topk_accumulate")
    assert op.kernel is not None
    d = torch.from_numpy(rng.standard_normal(30).astype(np.float32))
    i = torch.tensor([4, 9, 29], dtype=torch.int32)
    v = torch.tensor([1.0, -2.0, 0.5])
    assert torch.equal(op(d.clone(), i, v, use_kernel=True),
                       op(d.clone(), i, v))


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
# prefix_sum
#
# The reference's Pallas kernel scans 256-row chunks log-step in x's dtype
# and carries the last row; the port's plain version sums in order in f32
# (torch.cumsum, one rounding per output for bf16).  Bitwise wherever every
# partial sum is exact: integer-valued f32, and for bf16 a walk that stays
# in [0, 128].  On random data each side is within its rounding of the
# exact sum S_i = Σ_{t≤i} x_t: an f32 sum in any order within
# i·2^-24·A_i (A_i = Σ_{t≤i}|x_t|); the Pallas bf16 scan within
# (9 + i // 256)·2^-8·A_i (8 log-steps, the carry chain and its add, each
# rounding to bf16); the port's bf16 output within 2^-8·|S_i| + i·2^-24·A_i.
# ---------------------------------------------------------------------------

def bounded_walk(rng, shape) -> np.ndarray:
    """Steps in {-1, 0, 1} of a walk clipped to [0, 128] along axis 0:
    every partial sum of any contiguous run lies in [-128, 128], exact in
    bfloat16."""
    steps = rng.integers(-1, 2, shape)
    s, prev = np.zeros(shape, np.int64), np.zeros(shape[1:], np.int64)
    for t in range(shape[0]):
        prev = np.clip(prev + steps[t], 0, 128)
        s[t] = prev
    return np.diff(s, axis=0, prepend=0).astype(np.float32)


def prefix_bounds(x: np.ndarray, dt: str):
    """(port, reference) rounding bounds per output, as stated above."""
    a = np.cumsum(np.abs(x.astype(np.float64)), axis=0)
    i = np.arange(1, x.shape[0] + 1).reshape((-1,) + (1,) * (x.ndim - 1))
    f32 = i * 2.0 ** -24 * a
    if dt == "float32":
        return f32, f32
    exact = np.abs(np.cumsum(x.astype(np.float64), axis=0))
    return 2.0 ** -8 * exact + f32, (9 + (i - 1) // 256) * 2.0 ** -8 * a


@pytest.mark.parametrize("data", ["exact", "normal"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100,), (256,), (1000,), (100, 3),
                                   (256, 8), (1000, 5)])
def test_prefix_sum_plain_matches_pallas(rng, shape, dt, data):
    if data == "exact":
        x = rng.integers(-4, 5, shape).astype(np.float32) \
            if dt == "float32" else bounded_walk(rng, shape)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    x = x.astype(DTYPES[dt][0])
    want = np.asarray(jcs.prefix_sum(jnp.asarray(x), interpret=True))
    got = _numpy(tcs.prefix_sum(_torch(x)))
    if data == "exact":
        assert_bitwise(got, want)
        return
    tol_port, tol_ref = prefix_bounds(x.astype(np.float32), dt)
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64))
                  <= tol_port + tol_ref)


def test_prefix_sum_scans_one_dim_with_batch_and_lanes(rng):
    """``dim`` splits the dims: those before it are batch (rank dims on the
    fused path), those after it lanes — each (batch, lane) column is the
    reference kernel's ``[T, D]`` scan."""
    x = rng.integers(-4, 5, (3, 300, 2, 4)).astype(np.float32)
    got = tcs.prefix_sum(torch.from_numpy(x), dim=1).numpy()
    for b in range(3):
        want = np.asarray(jcs.prefix_sum(jnp.asarray(x[b].reshape(300, 8)),
                                         interpret=True))
        assert_bitwise(got[b].reshape(300, 8), want)
    assert_bitwise(tcs.prefix_sum(torch.from_numpy(x), dim=-3).numpy(), got)
    assert_bitwise(tcs.prefix_sum(torch.from_numpy(x), dim=3).numpy(),
                   np.cumsum(x, axis=3))


def test_prefix_sum_wrapper_on_cpu_runs_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((4, 33)).astype(np.float32))
    before = tcs.launches
    assert torch.equal(tcs.prefix_sum(x, dim=1), torch.cumsum(x, 1))
    assert torch.equal(tcs.prefix_sum(x[:, :0], dim=1), x[:, :0])
    i = torch.arange(10, dtype=torch.int32)
    assert tcs.prefix_sum(i).dtype == torch.int32     # as jnp.cumsum keeps it
    assert tcs.launches == before
    with pytest.raises(ValueError, match="at least one dim"):
        tcs.prefix_sum(torch.tensor(1.0))
    with pytest.raises(IndexError):
        tcs.prefix_sum(x, dim=2)


@pytest.mark.parametrize("shape,dim,want", [
    ((8, 1 << 20), 1, (8, 1 << 20, 1, 1, 128)),        # fig5_scan: 1,024 blocks
    ((8, 16384, 64), 1, (8, 16384, 64, 32, 64)),       # fig5_scan_2d: 2,048
    ((8, 12411), 1, (8, 12411, 1, 1, 2)),              # ragged T
    ((1000, 5), 0, (1, 1000, 5, 8, 1)),
    ((8, 1, 64), 1, (8, 1, 64, 32, 1)),                # T = 1: one pass
])
def test_prefix_sum_launch_layout(shape, dim, want):
    """Tiles of 8,192 elements: a block takes up to 32 lanes and
    (256 / lanes) · 32 rows."""
    b, t, d, lb, tiles = tcs.layout(shape, dim)
    assert (b, t, d, lb, tiles) == want
    rows = (256 // lb) * tcs.ROWS
    assert tcs.ROWS == 32 and tiles * rows >= t > (tiles - 1) * rows


@pytest.mark.parametrize("shape,dim,words", [
    ((8, 1 << 20), 1, 8 * 128 + 1),             # fig5_scan: 8 chains of 128
    ((8, 16384, 64), 1, 16 * 64 * 32 + 1),      # fig5_scan_2d: 16 of 64
    ((8, 12411), 1, 8 * 2 + 1),                 # ragged T
    ((3000, 5), 0, 3 * 8 + 1),                  # 5 lanes in a block of 8
    ((3, 300, 40), 1, 3 * 2 * 2 * 32 + 1),      # 40 lanes: 2 lane tiles
    ((8, 1, 64), 1, 0),                         # one tile: no look-back
    ((8, 8192), 1, 0),
])
def test_prefix_sum_scratch_layout(shape, dim, words):
    """The look-back's zeroed scratch: one 8-byte status word per lane of
    every tile of every chain (a batch row and a block's run of lanes),
    then the tile counter; nothing when every chain is one tile."""
    b, _, d, lb, tiles = tcs.layout(shape, dim)
    assert tcs.scratch_words(shape, dim) == words
    assert (words == 0) == (tiles == 1)
    if words:
        assert words - 1 == b * -(-d // lb) * tiles * lb


def test_registry_prefix_sum_kernel_and_plain_agree_on_cpu(rng):
    switchops.load_kernels()
    op = switchops.get("prefix_sum")
    assert op.kernel is not None
    x = _torch(_data(rng, 300, "float32")).reshape(3, 100)
    assert torch.equal(op(x, dim=1, use_kernel=True), op(x, dim=1))
    assert torch.equal(op(x), torch.cumsum(x, 0))


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
    got = tref.topk_accumulate(*map(torch.from_numpy,
                                    (dense.copy(), idx, vals)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_ref_topk_accumulate_is_the_kernels_plain_version(rng):
    """One plain version: the registry's, the wrapper's and the sparse
    ring's are ``ref.topk_accumulate`` — rows folded, in place,
    out-of-range indices dropped as the Pallas kernel drops them."""
    dense = rng.standard_normal((3, 40)).astype(np.float32)
    idx = np.array([[-1, 5, 40], [0, 39, 1000], [7, 7, 2]], np.int32)
    vals = rng.standard_normal((3, 3)).astype(np.float32)
    td = torch.from_numpy(dense.copy())
    assert tref.topk_accumulate(td, *map(torch.from_numpy,
                                         (idx, vals))) is td
    for r in range(3):
        want = jta.topk_accumulate(
            *map(jnp.asarray, (dense[r], idx[r], vals[r])), interpret=True)
        np.testing.assert_allclose(td[r].numpy(), np.asarray(want),
                                   rtol=0, atol=4 * 2.0 ** -23 * 8)
    same = torch.from_numpy(dense.copy())
    tta.plain(same, *map(torch.from_numpy, (idx, vals)))
    assert torch.equal(same, td)


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


def _wkv_args(rng, b, t, h, k, v, *, dtype=np.float32):
    """r, k, v, w in the model's [B, T, H, ·] layout, passed as [B, H, T,
    ·] views (as models.rwkv6.wkv does), u [H, K] and s0 [B, H, K, V]."""
    def act(width, scale=0.5):
        return torch.from_numpy((rng.standard_normal((b, t, h, width))
                                 * scale).astype(dtype)).transpose(1, 2)
    w = torch.from_numpy(rng.uniform(0.9, 1.0, (b, t, h, k)).astype(
        np.float32)).transpose(1, 2)
    u = torch.from_numpy((rng.standard_normal((h, k)) * 0.1).astype(
        np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, k, v)).astype(
        np.float32))
    return [act(k), act(k), act(v), w, u, s0]


def test_ref_rwkv6_recurrence_batches_over_leading_dims(rng):
    """[B, H, T, K] with u [H, K] and s0: each (b, h) equals the
    single-head plain version on its own slice, bit for bit."""
    r, k, v, w, u, s0 = _wkv_args(rng, 2, 7, 3, 8, 5)
    for kv_bf16 in (False, True):
        o, s = tref.rwkv6_recurrence(r, k, v, w, u, s0, kv_bf16=kv_bf16)
        assert o.shape == (2, 3, 7, 5) and s.shape == (2, 3, 8, 5)
        for b in range(2):
            for h in range(3):
                oh, sh = tref.rwkv6_recurrence(
                    r[b, h], k[b, h], v[b, h], w[b, h], u[h], s0[b, h],
                    kv_bf16=kv_bf16)
                assert torch.equal(o[b, h], oh) and torch.equal(s[b, h], sh)


def test_rwkv6_wrapper_on_cpu_runs_the_plain_version(rng):
    r, k, v, w, u, s0 = _wkv_args(rng, 2, 5, 2, 16, 16)
    before = trw.launches
    want_o, want_s = trw.plain(r, k, v, w, u, s0)
    o, s = trw.rwkv6_recurrence(r, k, v, w, u, s0)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    ptr = s0.data_ptr()
    o2, s2 = trw.rwkv6_recurrence(r, k, v, w, u, s0, s_out=s0)
    assert s2 is s0 and s0.data_ptr() == ptr and torch.equal(s0, want_s)
    assert torch.equal(o2, want_o) and trw.launches == before
    assert torch.equal(tops.rwkv6_recurrence(r, k, v, w, u)[0],
                       trw.plain(r, k, v, w, u)[0])


def test_rwkv6_wrapper_rejects_bad_operands(rng):
    r, k, v, w, u, s0 = _wkv_args(rng, 2, 5, 2, 8, 8)
    for bad in ((r, k[:, :, :4], v, w, u), (r, k, v[:, :1], w, u),
                (r, k, v, w, u[:1]), (r, k, v, w, u, s0[:1])):
        with pytest.raises(ValueError):
            trw.rwkv6_recurrence(*bad)
    with pytest.raises(ValueError, match="s_out"):
        trw.rwkv6_recurrence(r, k, v, w, u, s0, s_out=s0.double())


def test_rwkv6_kernel_reads_the_models_layout_through_strides():
    """The kernel's (batch, head, time) strides for the [B, H, T, ·] view
    of a contiguous [B, T, H, ·] activation; batch dims that fold into
    one; and ones that do not, which raise rather than copy."""
    x = torch.empty(8, 512, 32, 64).transpose(1, 2)
    assert trw._bht_strides(x) == (512 * 32 * 64, 64, 32 * 64)
    y = torch.empty(2, 3, 4, 5, 6)
    assert trw._bht_strides(y) == (4 * 5 * 6, 5 * 6, 6)
    assert trw._bht_strides(torch.empty(4, 5, 6)) == (0, 30, 6)
    with pytest.raises(ValueError, match="fold"):
        trw._bht_strides(y.transpose(0, 1))
    with pytest.raises(ValueError, match="unit-stride"):
        trw._bht_strides(y.transpose(3, 4))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype",
                         [torch.float32, torch.bfloat16, torch.int8])
def test_pack_kernel_many_parts_matches_plain_on_card(cuda_device, dtype):
    """More parts than one launch's parameter holds, ragged and offset
    off the 16-byte grid: one launch per group, bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sizes = [(7 * k) % 61 for k in range(130)]
    arena = torch.randn(8, sum(sizes) + 9, device=cuda_device,
                        generator=g).to(dtype)
    parts = [torch.randn(8, s, device=cuda_device, generator=g).to(dtype)
             for s in sizes]
    want = tpc.plain(arena.clone(), *parts, op="add")
    before = tpc.launches
    got = tpc.fused_pack(arena, *parts, op="add")
    assert tpc.launches == before + 2
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_hop_kernel_matches_plain_on_card(cuda_device, op):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    xs = torch.randn(2, 4, 4, 1003, device=cuda_device, generator=g)
    buf = torch.randn(2, 4, 1003, device=cuda_device, generator=g)
    for s in range(3):
        before = tfc.hop_launches
        got = tfc.fused_hop(buf, xs, s, dim=1, rank_ndim=2, op=op)
        assert tfc.hop_launches == before + 1
        assert torch.equal(got, tfc.hop_plain(buf, xs, s, dim=1,
                                              rank_ndim=2, op=op))


@pytest.mark.cuda
def test_quant_combine_kernel_matches_plain_on_card(cuda_device, rng):
    cases = [torch.from_numpy(c).to(cuda_device) for c in quant_cases(rng)]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rand = [torch.randint(-127, 128, (4096, 256), device=cuda_device,
                          generator=g, dtype=torch.int8),
            torch.rand(4096, device=cuda_device, generator=g),
            torch.randint(-127, 128, (4096, 256), device=cuda_device,
                          generator=g, dtype=torch.int8),
            torch.rand(4096, device=cuda_device, generator=g)]
    for qa, sa, qb, sb in (cases, rand):
        before = tqc.launches
        q, s = tqc.quant_combine(qa, sa, qb, sb)
        assert tqc.launches == before + 1
        wq, ws = tqc.plain(qa, sa, qb, sb)
        assert torch.equal(q, wq) and torch.equal(s, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("rank_shape,dim,rows", [((8,), 0, 1003),
                                                 ((2, 8), 1, 7)])
def test_quant_hop_kernel_matches_plain_on_card(cuda_device, rng,
                                                rank_shape, dim, rows):
    """Every hop of the ring on random rows, then on the exact rows (.5
    ties, zero rows, saturation): bitwise, one launch a hop."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n = rank_shape[dim]
    rand = [torch.randint(-127, 128, rank_shape + (rows, 256),
                          device=cuda_device, generator=g, dtype=torch.int8),
            torch.rand(rank_shape + (rows,), device=cuda_device, generator=g),
            torch.randint(-127, 128, rank_shape + (n, rows, 256),
                          device=cuda_device, generator=g, dtype=torch.int8),
            torch.rand(rank_shape + (n, rows), device=cuda_device,
                       generator=g)]
    exact = [t.to(cuda_device) for t in _hop_operands(
        *quant_cases(rng), rank_shape, n)]
    for ops in (rand, exact):
        for s in range(n - 1):
            before = tqc.hop_launches
            q, sc = tqc.quant_hop(*ops, s, dim=dim, rank_ndim=len(rank_shape))
            assert tqc.hop_launches == before + 1
            wq, ws = tqc.hop_plain(*ops, s, dim=dim,
                                   rank_ndim=len(rank_shape))
            assert torch.equal(q, wq) and torch.equal(sc, ws)


@pytest.mark.cuda
def test_topk_accumulate_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dense = torch.randn(8, 100_000, device=cuda_device, generator=g)
    idx = torch.stack([torch.randperm(100_000, device=cuda_device,
                                      generator=g)[:1000]
                       for _ in range(8)]).to(torch.int32)
    vals = torch.randn(8, 1000, device=cuda_device, generator=g)
    want = tta.plain(dense.clone(), idx, vals)
    before = tta.launches
    tta.topk_accumulate_(dense, idx, vals)
    assert tta.launches == before + 1
    assert torch.equal(dense, want)               # distinct: bitwise
    # spread duplicates, out-of-range indices, k not a multiple of 4
    idx = torch.randint(0, 100_000, (8, 1003), device=cuda_device,
                        generator=g, dtype=torch.int32)
    idx[:, 1::97] = idx[:, :1]
    idx[:, 2::101] = -1
    idx[:, 3::101] = 100_000
    vals = torch.randn(8, 1003, device=cuda_device, generator=g)
    want = tta.plain(dense.clone(), idx, vals)
    absum = tta.plain(dense.abs(), idx, vals.abs())
    keep = (idx >= 0) & (idx < 100_000)
    mult = max(int(torch.bincount(row[m].long()).max())
               for row, m in zip(idx, keep))
    tta.topk_accumulate_(dense, idx, vals)
    assert tta.launches == before + 2
    assert bool(((dense - want).abs() <= mult * 2.0 ** -23 * absum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((8, 12411), 1), ((8, 1000, 64), 1),
                                       ((3, 1000, 5), 1), ((8, 1, 64), 1),
                                       ((100003,), 0)])
def test_prefix_sum_kernel_matches_plain_on_card(cuda_device, shape, dim):
    """Integer-valued data: every partial sum exact, so the kernel equals
    torch.cumsum bit for bit in any order."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-1, 2, shape, device=cuda_device, generator=g,
                      dtype=torch.int32).float()
    before = tcs.launches
    got = tcs.prefix_sum(x, dim=dim)
    assert tcs.launches == before + 1
    assert torch.equal(got, tcs.plain(x, dim))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1 << 20), (8, 16384, 64)])
def test_prefix_sum_kernel_random_within_rounding_on_card(cuda_device,
                                                          shape):
    """Random data over many tiles, through the look-back: each output
    within the f32 rounding of any summation order, i·2^-24·Σ|x|, of the
    exact sum, in one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=g)
    before = tcs.launches
    got = tcs.prefix_sum(x, dim=1)
    assert tcs.launches == before + 1
    exact = torch.cumsum(x.double(), 1)
    i = torch.arange(1, shape[1] + 1, device=cuda_device,
                     dtype=torch.float64).reshape((-1,) + (1,) * (x.dim() - 2))
    bound = i * 2.0 ** -24 * torch.cumsum(x.double().abs(), 1)
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_bf16", [False, True])
def test_rwkv6_kernel_matches_plain_on_card(cuda_device, rng, dtype,
                                            kv_bf16):
    """The model's layout (strided views) at decode (T = 1, state in
    place) and prefill-like T, and K and V off the kernel's lane split:
    within ``wkv_tolerance`` of the float64 recurrence, as the plain
    version is; the build's launch shape is the wrapper's."""
    for t, k_, v_ in ((1, 64, 64), (37, 64, 64), (77, 40, 24), (9, 64, 56),
                      (1, 64, 40)):
        assert trw.built_launch_shape(k_, v_) == trw.launch_shape(k_, v_)
        args = [a.to(cuda_device) for a in _wkv_args(rng, 2, t, 4, k_, v_)]
        args[:3] = [a.to(dtype) for a in args[:3]]
        r, k, v, w, u, s0 = args
        eo, es, otol, stol = trw.wkv_tolerance(r, k, v, w, u, s0,
                                               kv_bf16=kv_bf16)
        po, ps = trw.plain(r, k, v, w, u, s0, kv_bf16=kv_bf16)
        before = trw.launches
        o, s = trw.rwkv6_recurrence(r, k, v, w, u, s0, kv_bf16=kv_bf16,
                                    s_out=s0)
        assert trw.launches == before + 1 and s is s0
        assert o.dtype == dtype and o.stride() == v.stride()
        for got_o, got_s in ((o, s), (po, ps)):
            assert bool(((got_o.double() - eo).abs() <= otol).all())
            assert bool(((got_s.double() - es).abs() <= stol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_on_card(cuda_device, dtype):
    """Decode (T = 1) and prefill-like T from a state written in place,
    ragged lanes: bit for bit equal to the plain version (both round the
    product and the sum separately), and within ``rglru_tolerance``."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for t, d in ((1, 4096), (37, 1000)):
        a = (0.9 + 0.1 * torch.rand(3, t, d, device=cuda_device,
                                    generator=g)).to(dtype)
        b = torch.randn(3, t, d, device=cuda_device, generator=g).to(dtype)
        h0 = torch.randn(3, d, device=cuda_device, generator=g)
        want = tcs.rglru_plain(a, b, h0)
        exact, tol = tcs.rglru_tolerance(a, b, h0)
        before = tcs.rglru_launches
        got = tcs.rglru_scan(a, b, h0, h_out=h0)
        assert tcs.rglru_launches == before + 1
        assert torch.equal(got, want) and torch.equal(h0, got[:, -1])
        assert bool(((got.double() - exact).abs() <= tol).all())

