"""On-wire codecs — ACiS Type 0 stream transforms + Type 2 wire datatypes.

The PyTorch counterpart of :mod:`repro.core.wire`.  A :class:`WireCodec`
is a pair ``encode/decode`` plus, optionally, an *encoded-domain combine*
— the in-switch aggregation that merges two encoded payloads without a
round trip through the decoded domain (dequant-add-requant).

Every function here is rank-local: inside ``with mesh:`` each rank's
payload is the tensor without its rank dims, outside any mesh the whole
tensor is one payload.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import quant_combine as _qc
from repro_torch.kernels.ref import block_scale
from repro_torch.mesh import ambient

PyTree = Any


@dataclasses.dataclass(frozen=True)
class WireCodec:
    name: str
    encode: Callable[[torch.Tensor], PyTree]
    decode: Callable[[PyTree], torch.Tensor]
    # Optional encoded-domain combine (incoming, local) -> encoded.
    combine_encoded: Optional[Callable[[PyTree, PyTree], PyTree]] = None
    # Bytes-on-wire multiplier vs f32 (for the roofline/emulator accounting).
    wire_ratio: float = 1.0

    def __repr__(self) -> str:  # pragma: no cover
        return f"WireCodec({self.name})"


# ---------------------------------------------------------------------------
# Type 0: pure stream transforms.
# ---------------------------------------------------------------------------

IDENTITY = WireCodec("identity", lambda x: x, lambda x: x, wire_ratio=1.0)


def _cast_codec(name: str, wire_dtype: torch.dtype,
                ratio: float) -> WireCodec:
    return WireCodec(name, lambda x: x.to(wire_dtype),
                     lambda y: y.to(torch.float32), wire_ratio=ratio)


BF16 = _cast_codec("bf16", torch.bfloat16, 0.5)
FP8 = _cast_codec("fp8_e4m3", torch.float8_e4m3fn, 0.25)

_U32 = 0xFFFFFFFF


def checksum_tag(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """Type 0 'append a CRC' analogue: fletcher-style checksum sidecar.

    Per rank: the uint32 sum of the f32 bit patterns and the uint32 sum of
    their low 16 bits, both held as int64 (torch has no wrapping uint32
    arithmetic).  ``checksum_verify`` recomputes and compares.
    """
    flat = ambient().flatten_local(x).to(torch.float32)
    bits = flat.contiguous().view(torch.int32).to(torch.int64) & _U32
    total = bits.sum(-1) & _U32
    low = (bits & 0xFFFF).sum(-1) & _U32
    return x, (total, low)


def checksum_verify(x: torch.Tensor, tag) -> torch.Tensor:
    _, fresh = checksum_tag(x)
    return (fresh[0] == tag[0]) & (fresh[1] == tag[1])


# ---------------------------------------------------------------------------
# Type 2 wire datatype: blockwise-int8 quantized tensors (payload + scales).
# ---------------------------------------------------------------------------

QBLOCK = 256  # elements per quantization block


def quantize_int8(x: torch.Tensor, block: int = QBLOCK
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise symmetric int8 quantization of each rank's payload.

    Returns (q[*rank, nblocks, block] int8, scales[*rank, nblocks] f32,
    orig_size).  ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    tp = ambient()
    flat = tp.flatten_local(x).to(torch.float32)
    size = flat.shape[-1]
    pad = (-size) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    blocks = flat.reshape(flat.shape[:-1] + (-1, block))
    scale = block_scale(blocks.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0], size


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, size: int,
                    shape=None, dtype=torch.float32) -> torch.Tensor:
    tp = ambient()
    out = tp.flatten_local(q.to(torch.float32) * scale[..., None])
    out = out[..., :size]
    if shape is not None:
        out = tp.reshape_local(out, shape).to(dtype)
    return out


def int8_codec(block: int = QBLOCK, *,
               use_kernels: bool = False) -> WireCodec:
    """int8-blockwise codec with encoded-domain combine.

    Quantized combine is lossy and (mildly) order-dependent.  Encode
    assumes one fixed payload shape per call site.  With ``use_kernels``
    the combine is the ``quant_combine`` kernel wrapper
    (:mod:`repro_torch.kernels.quant_combine`, 256-lane blocks): it
    launches the CUDA kernel on CUDA payloads — one launch per ring hop,
    every rank's chunk at once — and runs the kernel's plain version on
    CPU ones; its ``fused_hop`` attribute is the one-launch ring
    reduce-scatter step (:func:`~repro_torch.kernels.quant_combine.
    quant_hop`), which the encoded ring takes on CUDA payloads in place of
    roll, gather and combine.  Without it the combine is that plain
    version everywhere: dequant both, add in f32, requant with a fresh
    per-block absmax scale.
    """
    fn = _qc.quant_combine if use_kernels else _qc.plain

    def combine(incoming, local):
        return fn(*incoming, *local)

    if use_kernels:
        def fused_hop(buf, xs, s, *, dim, rank_ndim):
            return _qc.quant_hop(*buf, *xs, s, dim=dim, rank_ndim=rank_ndim)
        combine.fused_hop = fused_hop

    shape_box = {}

    def encode(x):
        shape_box["shape"] = ambient().local_shape(x)
        shape_box["dtype"] = x.dtype
        q, s, size = quantize_int8(x, block)
        shape_box["size"] = size
        return q, s

    def decode(p):
        q, s = p
        return dequantize_int8(q, s, shape_box["size"],
                               shape_box["shape"], shape_box["dtype"])

    # wire_ratio: 1 byte payload + 4/block scales vs 4 bytes f32
    ratio = (1.0 + 4.0 / block) / 4.0
    return WireCodec(f"int8_b{block}", encode, decode,
                     combine_encoded=combine, wire_ratio=ratio)


CODECS = {
    "identity": IDENTITY,
    "bf16": BF16,
    "fp8": FP8,
}


def resolve_codec(name: str) -> WireCodec:
    """Codec by config name.  ``"int8"`` builds a *fresh* instance — its
    encode/decode pair carries per-call-site shape state and must not be
    shared between compiled programs."""
    if name in CODECS:
        return CODECS[name]
    if name == "int8":
        return int8_codec()
    raise ValueError(f"unknown wire codec {name!r}; "
                     f"expected one of {sorted(CODECS) + ['int8']}")
