"""The fused attention kernel (``kernels/flash_attention.py``) and its
dispatch rule (``takes``), which sends :func:`repro_torch.models.
attention.flash_attention` calls to it.

On the CPU: the dispatch rule (which argument forms go to the kernel and
which keep the plain loop), the three-part bf16 split of f32 operands
(sums back exactly), and the kernels' equations in plain PyTorch (the
forward's f32 O and LSE; the backward's P recomputed from the LSE, D from
the f32 O, dS = P (dP - D)) against the plain loop and its autograd in
f32.  Tolerance there: 2e-6 (forward) and 1e-5 (gradients) of the
largest magnitude -- the same f32 values summed in another order (dense
against chunked; the gradients' dP - D cancels, hence the wider bound).

On the card (``cuda`` mark, skips here; no JAX imported, so run with
``--noconftest``): the kernels against the plain loop on the same bf16
operands at the benchmark's shapes with the rank dim in front (whisper's
encoder 1,500 x 1,500, its decoder's causal 256, cross attention 256 x
1,500, acis-100m's causal GQA 12 / 4 over 256) and at edge forms (one
query row, key counts off the 64-row tile, a window, an offset, other
head dims).  Tolerances, each with its reason:

* the f32 O's error from a float64 dense reference within 4x the plain
  f32 form's (f32 sums in another order: the tensor cores' and the
  online softmax's against cuBLAS's), and under 1/64 of the error a P
  rounded to one bf16 gives (~1e-3 of the largest magnitude): every f32
  operand reaches the tensor cores in full.  The LSE within 1e-6 of its
  largest magnitude (log2 of f32 sums);
* bf16 outputs and gradients within one bf16 ulp (2^-7 relative) plus
  1e-5 of the largest magnitude of the plain loop's: both round an f32
  value once, and the f32 values differ by their summation order (more
  where dP - D cancels).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TA


@pytest.fixture
def cuda_device():
    # decided here, at run time, never at import or collection
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernels run only on "
                    "the card")
    return torch.device("cuda")


def _qkv(shape_q, shape_kv, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dtype)
               for s in (shape_q, shape_kv, shape_kv))
    return q, k, v


# ---------------------------------------------------------------------------
# the dispatch rule (CPU)
# ---------------------------------------------------------------------------

BF = torch.bfloat16


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: the rule's form half, here."""

    @property
    def is_cuda(self):
        return True


def _form(q_shape, kv_shape, v_d=None, dtype=BF, **kw):
    args = dict(causal=True, window=None, q_offset=0, kv_len=None)
    args.update(kw)
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(kv_shape, dtype=dtype)
    v = torch.zeros(kv_shape[:-1] + (v_d or kv_shape[-1],), dtype=dtype)
    return FA.takes(*(x.as_subclass(_OnCard) for x in (q, k, v)), **args)


@pytest.mark.parametrize("case,want", [
    (dict(q_shape=(8, 4, 1500, 12, 64), kv_shape=(8, 4, 1500, 12, 64),
          causal=False), True),                     # whisper's encoder
    (dict(q_shape=(8, 4, 256, 12, 64), kv_shape=(8, 4, 1500, 12, 64),
          causal=False), True),                     # its cross attention
    (dict(q_shape=(8, 8, 256, 12, 64), kv_shape=(8, 8, 256, 4, 64)),
     True),                                         # acis-100m's GQA
    (dict(q_shape=(2, 300, 4, 128), kv_shape=(2, 300, 1, 128), window=40),
     True),                                         # window_prefill's form
    (dict(q_shape=(2, 5, 4, 64), kv_shape=(2, 20, 4, 64), q_offset=15),
     True),                                         # a query block at 15
    (dict(q_shape=(2, 1, 4, 64), kv_shape=(2, 20, 4, 64),
          kv_len=torch.tensor(7)), False),          # decode: kv_len
    (dict(q_shape=(2, 1, 4, 64), kv_shape=(2, 20, 4, 64),
          q_offset=torch.tensor([3, 9])), False),   # per-row q_offset
    (dict(q_shape=(2, 9, 4, 64), kv_shape=(2, 9, 4, 64), v_d=32),
     False),                                        # d != dv, not (192, 128)
    (dict(q_shape=(8, 2, 4096, 16, 192), kv_shape=(8, 2, 4096, 16, 192),
          v_d=128), True),                          # MLA's per-head form
    (dict(q_shape=(2, 9, 4, 192), kv_shape=(2, 9, 4, 192), v_d=64),
     False),                                        # (192, 64)
    (dict(q_shape=(2, 9, 4, 192), kv_shape=(2, 9, 4, 192)), False),  # 192
    (dict(q_shape=(2, 9, 4, 128), kv_shape=(2, 9, 4, 128), v_d=192),
     False),                                        # (128, 192)
    (dict(q_shape=(2, 9, 4, 256), kv_shape=(2, 9, 4, 256)), False),  # d>128
    (dict(q_shape=(2, 9, 4, 20), kv_shape=(2, 9, 4, 20)), False),  # d % 8
    (dict(q_shape=(2, 9, 6, 64), kv_shape=(2, 9, 4, 64)), False),  # heads
    (dict(q_shape=(2, 9, 4, 64), kv_shape=(2, 9, 4, 64),
          dtype=torch.float32), False),             # f32 operands
    (dict(q_shape=(2, 2, 9, 4, 64), kv_shape=(1, 2, 9, 4, 64)),
     False),                                        # broadcast leading dims
    (dict(q_shape=(2, 5, 4, 64), kv_shape=(2, 20, 4, 64), q_offset=-1),
     False),                                        # row 0 sees no key
    (dict(q_shape=(2, 9, 4, 64), kv_shape=(2, 3, 4, 64), causal=False,
          window=2), False),                        # the window passes Tk
])
def test_dispatch_rule_by_argument_form(case, want):
    assert _form(**case) is want


def test_cpu_operands_keep_the_plain_loop():
    """The rule's device half: CPU operands never reach the kernel, and
    its wrapper refuses them."""
    q, k, v = _qkv((2, 9, 4, 64), (2, 9, 4, 64), BF)
    kw = dict(causal=True, window=None, q_offset=0, kv_len=None)
    assert FA.takes(*(x.as_subclass(_OnCard) for x in (q, k, v)), **kw)
    assert not FA.takes(q, k, v, **kw)
    with pytest.raises(ValueError):
        FA.forward(q, k, v, hi=0, lo=None, scale=0.125)


@pytest.mark.parametrize("tq,tk,causal,window,off", [
    (5, 9, True, None, 0), (5, 9, True, 3, 4), (5, 9, False, 2, 3),
    (5, 9, True, 1, -1), (7, 3, False, 2, 0), (1, 1, True, 1, 0),
    (4, 6, True, None, 2), (4, 6, False, 4, 5), (3, 8, True, 2, 9)])
def test_rows_see_keys_matches_the_mask(tq, tk, causal, window, off):
    i = np.arange(tq)[:, None] + off
    j = np.arange(tk)[None]
    ok = np.ones((tq, tk), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    assert FA.rows_see_keys(tq, tk, causal, window, off) == \
        bool(ok.any(1).all())


# ---------------------------------------------------------------------------
# the three-part split (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-20, 1e-6, 1e-2, 1.0, 3e3, 1e30])
def test_split3_sums_back_exactly(scale):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(100_000, generator=g) * scale
    hi, mid, lo = FA.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    # one part, or two, is not the f32 value
    assert (hi.double() != x.double()).float().mean() > 0.9
    assert (hi.double() + mid.double() != x.double()).float().mean() > 0.5


def test_split3_of_every_exponent():
    """Random significands at every exponent from 2^-100 to 2^100, and
    the softmax's range of P, 0 to 1."""
    g = torch.Generator().manual_seed(2)
    bits = torch.randint(0, 2 ** 23, (201,), generator=g, dtype=torch.int32)
    exps = torch.arange(-100, 101, dtype=torch.int32) + 127
    x = ((exps << 23) | bits).view(torch.float32)
    x = torch.cat([x, -x, torch.rand(10_000, generator=g), torch.zeros(1)])
    hi, mid, lo = FA.split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


# ---------------------------------------------------------------------------
# the kernels' equations against the plain loop (CPU, f32)
# ---------------------------------------------------------------------------

FORMS = [  # (tq, tk, hq, hkv, d, causal, window, q_offset)
    (19, 19, 4, 2, 16, False, None, 0),     # encoder self attention
    (19, 19, 4, 1, 16, True, None, 0),      # causal MQA
    (7, 23, 4, 4, 16, False, None, 0),      # cross attention
    (9, 40, 6, 2, 8, True, 5, 31),          # a window, a query block at 31
    (1, 13, 2, 2, 16, True, None, 12),      # one query row at its end
]


def _plain(q, k, v, causal, window, off):
    return TA.plain_flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=off, kv_len=None, chunk=8,
                                    scale=1 / math.sqrt(q.shape[-1]))


def _close(got, want, rel):
    want = want.double()
    err = (got.double() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.parametrize("form", FORMS)
def test_plain_forward_equations_match_the_loop(form):
    tq, tk, hq, hkv, d, causal, window, off = form
    q, k, v = _qkv((2, tq, hq, d), (2, tk, hkv, d))
    hi, lo = FA.mask_bounds(causal, window, off)
    o32, lse = FA.plain_forward(q, k, v, hi=hi, lo=lo,
                                scale=1 / math.sqrt(d))
    assert o32.shape == q.shape and lse.shape == (2, hq, tq)
    _close(o32, _plain(q, k, v, causal, window, off), 2e-6)
    # lse is the log2-sum-exp of the scaled scores
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double().repeat_interleave(hq // hkv, 2)) \
        / math.sqrt(d) * FA.LOG2E
    j = torch.arange(tk)[None]
    i = torch.arange(tq)[:, None] + off
    mask = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    want = torch.logsumexp(s.masked_fill(~mask, -math.inf) / FA.LOG2E,
                           -1) * FA.LOG2E
    _close(lse, want, 2e-6)


@pytest.mark.parametrize("form", FORMS)
def test_plain_backward_equations_match_autograd(form):
    """D from the f32 O, P recomputed from the LSE, dS = P (dP - D):
    autograd's gradients of the plain loop, in f32."""
    tq, tk, hq, hkv, d, causal, window, off = form
    q, k, v = _qkv((2, tq, hq, d), (2, tk, hkv, d), seed=3)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = TA.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off, chunk=8)
    want = torch.autograd.grad(out, (q, k, v), do)
    hi, lo = FA.mask_bounds(causal, window, off)
    scale = 1 / math.sqrt(d)
    o32, lse = FA.plain_forward(q.detach(), k.detach(), v.detach(), hi=hi,
                                lo=lo, scale=scale)
    got = FA.plain_backward(q.detach(), k.detach(), v.detach(), o32, lse, do,
                            hi=hi, lo=lo, scale=scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-5)


def test_work_counts_the_visible_pairs():
    full = FA.work(2, 64, 64, 4, 64)
    causal = FA.work(2, 64, 64, 4, 64, hi=0)
    assert full["forward"] == 2 * 4 * 64 * 64 * 8 * 64
    assert causal["forward"] * 2 == full["forward"] + 2 * 4 * 64 * 8 * 64
    assert full["backward"] == full["forward"] * 26 // 8
    assert full["plain_backward"] == full["plain_forward"] * 10 // 4
    # MLA's per-head widths: 2(d + dv) forward, 2(3d + 2dv) backward a pair
    wide = FA.work(2, 4096, 4096, 16, 192, hi=0, dv=128)
    pairs = 2 * 16 * 4096 * 4097 // 2
    assert wide["plain_forward"] == pairs * 2 * (192 + 128)
    assert wide["plain_backward"] == pairs * 2 * (3 * 192 + 2 * 128)
    assert wide["forward"] == pairs * (2 * 192 + 6 * 128)


@pytest.mark.parametrize("tq,tk,causal,window,off", [
    (5, 9, True, None, 0), (5, 9, True, 3, 4), (5, 9, False, 2, 3),
    (7, 3, False, 2, 0), (4, 6, True, None, 2), (3, 8, True, 2, 9),
    (9, 4, False, None, 0), (64, 64, True, None, 0)])
def test_visible_pairs_counts_the_mask(tq, tk, causal, window, off):
    hi, lo = FA.mask_bounds(causal, window, off)
    assert FA.visible_pairs(tq, tk, hi, lo) == \
        int(FA._visible(tq, tk, hi, lo, "cpu").sum())


def test_wide_key_equations_match_the_loop():
    """The kernels' equations at a key wider than the value (192 / 128
    in the card's form, 24 / 16 here) against the plain loop and its
    autograd, f32."""
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn(2, 21, 4, 24, generator=g) for _ in range(2))
    v = torch.randn(2, 21, 4, 16, generator=g)
    do = torch.randn(2, 21, 4, 16, generator=g)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = TA.flash_attention(q, k, v, causal=True, chunk=8)
    want = torch.autograd.grad(out, (q, k, v), do)
    hi, lo = FA.mask_bounds(True, None, 0)
    o32, lse = FA.plain_forward(q.detach(), k.detach(), v.detach(), hi=hi,
                                lo=lo, scale=1 / math.sqrt(24))
    _close(o32, out.detach(), 2e-6)
    got = FA.plain_backward(q.detach(), k.detach(), v.detach(), o32, lse,
                            do, hi=hi, lo=lo, scale=1 / math.sqrt(24))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

CARD = {  # name: (q shape, k/v shape, causal, window, q_offset)
    "whisper_encoder": ((8, 4, 1500, 12, 64), (8, 4, 1500, 12, 64), False,
                        None, 0),
    "whisper_decoder": ((8, 4, 256, 12, 64), (8, 4, 256, 12, 64), True,
                        None, 0),
    "whisper_cross": ((8, 4, 256, 12, 64), (8, 4, 1500, 12, 64), False,
                      None, 0),
    "acis_100m_gqa": ((8, 8, 256, 12, 64), (8, 8, 256, 4, 64), True, None,
                      0),
    "one_row": ((3, 1, 4, 64), (3, 77, 2, 64), True, None, 76),
    "ragged_keys": ((2, 130, 4, 64), (2, 77, 4, 64), False, None, 0),
    "window": ((2, 300, 8, 64), (2, 300, 2, 64), True, 40, 0),
    "offset_block": ((2, 100, 4, 64), (2, 300, 4, 64), True, None, 200),
    "d128_window": ((2, 200, 4, 128), (2, 200, 1, 128), True, 70, 0),
    "d32_cross": ((2, 65, 2, 32), (2, 129, 2, 32), False, None, 0),
    "d80_noncausal_window": ((2, 90, 3, 80), (2, 90, 3, 80), False, 30, 0),
}


def _card_case(name, dev, seed=0):
    qs, ks, causal, window, off = CARD[name]
    q, k, v = _qkv(qs, ks, BF, dev, seed)
    do = torch.randn(qs, generator=torch.Generator().manual_seed(seed + 1)
                     ).to(device=dev, dtype=BF)
    return q, k, v, do, dict(causal=causal, window=window, q_offset=off)


def _run(fn, q, k, v, do, kw):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v, **kw)
    return (out, *torch.autograd.grad(out, (q, k, v), do))


def _within_ulp(got, want, what):
    g, w = got.double(), want.double()
    tol = 2.0 ** -7 * w.abs() + 1e-5 * w.abs().max()
    bad = ((g - w).abs() > tol).sum().item()
    assert bad == 0, (f"{what}: {bad} elements off, max |err| "
                      f"{(g - w).abs().max().item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD))
def test_kernel_matches_the_plain_loop_on_card(cuda_device, name):
    q, k, v, do, kw = _card_case(name, cuda_device)
    d = q.shape[-1]
    assert FA.takes(q, k, v, kv_len=None, **kw)
    n_fwd, n_bwd = FA.launches, FA.bwd_launches

    def plain(q, k, v, **kw):
        return TA.plain_flash_attention(q, k, v, kv_len=None, chunk=1024,
                                        scale=1 / math.sqrt(d), **kw)
    got = _run(TA.flash_attention, q, k, v, do, kw)
    torch.cuda.synchronize()
    assert FA.launches == n_fwd + 1 and FA.bwd_launches == n_bwd + 1
    want = _run(plain, q, k, v, do, kw)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == BF and g.shape == w.shape
        _within_ulp(g, w, what)

    # the f32 O and LSE against a float64 dense reference, beside the
    # plain f32 form's error and a P rounded to one bf16
    hi, lo = FA.mask_bounds(kw["causal"], kw["window"], kw["q_offset"])
    flat = [x.reshape((-1,) + x.shape[-3:])[:2] for x in (q, k, v)]
    scale = 1 / math.sqrt(d)
    _, o32, lse = FA.forward(*flat, hi=hi, lo=lo, scale=scale)
    exact, lse64 = FA.plain_forward(*(x.double() for x in flat), hi=hi,
                                    lo=lo, scale=scale)
    f32, _ = FA.plain_forward(*flat, hi=hi, lo=lo, scale=scale)
    p, _ = FA.plain_probs(*(x.double() for x in flat[:2]), hi=hi, lo=lo,
                          scale=scale)
    bf16_p = torch.einsum("...hgqk,...khd->...qhgd", p.bfloat16().double(),
                          flat[2].double()).reshape(exact.shape)
    err = {name: (x.double() - exact).abs().max().item()
           for name, x in (("kernel", o32), ("f32", f32), ("bf16_p", bf16_p))}
    assert err["kernel"] <= 4 * err["f32"], err
    assert err["kernel"] * 64 <= err["bf16_p"], err
    _close(lse, lse64, 1e-6)


def _exact(q, k, v, do, scale):
    """Causal attention of float64 copies and its gradients."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    tq = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(torch.ones(tq, tq, dtype=torch.bool,
                                 device=q.device).triu(1), -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do.double()))


@pytest.mark.cuda
def test_wide_keys_against_float64_on_card(cuda_device):
    """MLA's per-head form at the cell's shape, [2, 4096, 16] causal, q
    and k 192 wide, v 128: the bf16 output and gradients within one bf16
    ulp (2^-7 relative) plus 1e-5 of the largest magnitude of the float64
    result (one rounding of an f32 value); the f32 O's error within 4x
    the plain f32 form's (cuBLAS's f32 products, no TF32)."""
    g = torch.Generator().manual_seed(6)
    q, k = (torch.randn(2, 4096, 16, 192, generator=g).to(cuda_device, BF)
            for _ in range(2))
    v = torch.randn(2, 4096, 16, 128, generator=g).to(cuda_device, BF)
    do = torch.randn(2, 4096, 16, 128, generator=g).to(cuda_device, BF)
    scale = 1 / math.sqrt(192)
    kw = dict(causal=True, window=None, q_offset=0)
    assert FA.takes(q, k, v, kv_len=None, **kw)
    got = _run(lambda q, k, v, **kw: TA.flash_attention(
        q, k, v, softmax_scale=scale, **kw), q, k, v, do, kw)
    want = _exact(q, k, v, do, scale)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == BF and a.shape == b.shape
        _within_ulp(a, b, what)
    hi, lo = FA.mask_bounds(True, None, 0)
    _, o32, _ = FA.forward(q, k, v, hi=hi, lo=lo, scale=scale)
    f32, _ = FA.plain_forward(q, k, v, hi=hi, lo=lo, scale=scale)
    err_kernel = (o32.double() - want[0]).abs().max().item()
    err_f32 = (f32.double() - want[0]).abs().max().item()
    assert err_kernel <= 4 * err_f32, (err_kernel, err_f32)


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda_device):
    """No atomics: two runs give bit-identical outputs and gradients."""
    q, k, v, do, kw = _card_case("acis_100m_gqa", cuda_device)
    a = _run(TA.flash_attention, q, k, v, do, kw)
    b = _run(TA.flash_attention, q, k, v, do, kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_engage_counter_on_card(cuda_device):
    """``kernel.attention.calls`` counts the kernel's calls and
    ``attention.plain_calls`` the plain loop's on the card, while spans
    are recorded."""
    q, k, v, do, kw = _card_case("whisper_decoder", cuda_device)
    with obs.recording(spans=True) as rec:
        TA.flash_attention(q, k, v, **kw)
        TA.flash_attention(q, k, v, causal=False)
        TA.flash_attention(q[..., :1, :, :], k, v, causal=False,
                           kv_len=torch.tensor(9, device=cuda_device))
    assert rec.counter("kernel.attention.calls") == 2
    assert rec.counter("attention.plain_calls") == 1
    with obs.recording() as rec:        # spans off: nothing counted
        TA.flash_attention(q, k, v, **kw)
    assert rec.counter("kernel.attention.calls") == 0
