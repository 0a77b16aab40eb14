"""The parameter layout of a configuration, from its JSON file alone.

Every leaf is ``(path, shape, dtype, init)``: ``path`` joins the keys of
the nested parameter dict with dots, ``init`` is ``("ones",)``,
``("zeros",)`` or ``("normal", std)``.  The benchmark draws the weights
from this list (``harness/weights.py``) and hands the same values to the
program and to the plain reference; set-up holds the program's own
layout against it, so a program that stores another tree fails loudly.

Families: ``dense`` (RMSNorm, RoPE, GQA, SwiGLU; a stack of ``self``
blocks) and ``encdec`` (LayerNorm with bias, no RoPE, GELU; an encoder
of ``enc_self`` blocks over a stub context and a decoder of
``dec_self_cross`` blocks).  Layers are stacked: a leaf of a block has
the layer count as its first dim.  With ``tie_embeddings`` the logits
read the token embedding (transposed) and there is no ``lm_head``; the
embedding is then drawn at the output projection's scale,
``1/sqrt(d_model)``, and otherwise at 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class Leaf(NamedTuple):
    path: str
    shape: tuple
    dtype: torch.dtype
    init: tuple


def head_dim(cfg: dict) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def _norm(prefix: str, cfg: dict, lead: tuple) -> list[Leaf]:
    d = cfg["d_model"]
    out = [Leaf(prefix + ".scale", lead + (d,), torch.float32, ("ones",))]
    if cfg["norm"] == "layer":
        out.append(Leaf(prefix + ".bias", lead + (d,), torch.float32,
                        ("zeros",)))
    return out


def _dense(path: str, d_in: int, d_out: int, dt, lead: tuple) -> Leaf:
    return Leaf(path, lead + (d_in, d_out), dt,
                ("normal", 1.0 / math.sqrt(d_in)))


def _attn(prefix: str, cfg: dict, dt, lead: tuple) -> list[Leaf]:
    d, hd = cfg["d_model"], head_dim(cfg)
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return [_dense(prefix + ".wq", d, q, dt, lead),
            _dense(prefix + ".wk", d, kv, dt, lead),
            _dense(prefix + ".wv", d, kv, dt, lead),
            _dense(prefix + ".wo", q, d, dt, lead)]


def _ffn(prefix: str, cfg: dict, dt, lead: tuple) -> list[Leaf]:
    d, f = cfg["d_model"], cfg["d_ff"]
    if cfg["activation"] in ("swiglu", "geglu"):
        return [_dense(prefix + ".wi_gate", d, f, dt, lead),
                _dense(prefix + ".wi_up", d, f, dt, lead),
                _dense(prefix + ".wo", f, d, dt, lead)]
    return [_dense(prefix + ".wi", d, f, dt, lead),
            _dense(prefix + ".wo", f, d, dt, lead)]


def param_spec(cfg: dict) -> list[Leaf]:
    """Every parameter leaf of ``cfg``, sorted by path."""
    dt = DTYPES[cfg["param_dtype"]]
    d, v, n = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    if cfg.get("tie_embeddings"):
        leaves = [Leaf("embed", (v, d), dt, ("normal", 1.0 / math.sqrt(d)))]
    else:
        leaves = [Leaf("embed", (v, d), dt, ("normal", 1.0)),
                  _dense("lm_head", d, v, dt, ())]
    leaves += _norm("final_norm", cfg, ())
    lead = (n,)
    if cfg["family"] == "dense":
        blk = "layers.pos0_self"
        leaves += _norm(blk + ".ln1", cfg, lead) + _norm(blk + ".ln2", cfg,
                                                         lead)
        leaves += _attn(blk + ".attn", cfg, dt, lead)
        leaves += _ffn(blk + ".ffn", cfg, dt, lead)
    elif cfg["family"] == "encdec":
        e = cfg["encdec"]
        blk = "layers.pos0_dec_self_cross"
        for ln in ("ln1", "ln2", "ln_x"):
            leaves += _norm(f"{blk}.{ln}", cfg, lead)
        leaves += _attn(blk + ".attn", cfg, dt, lead)
        leaves += _attn(blk + ".xattn", cfg, dt, lead)
        leaves += _ffn(blk + ".ffn", cfg, dt, lead)
        elead = (e["n_encoder_layers"],)
        eblk = "enc.layers.pos0_enc_self"
        leaves += _norm(eblk + ".ln1", cfg, elead) + _norm(eblk + ".ln2",
                                                           cfg, elead)
        leaves += _attn(eblk + ".attn", cfg, dt, elead)
        leaves += _ffn(eblk + ".ffn", cfg, dt, elead)
        leaves += _norm("enc.final_norm", cfg, ())
        leaves.append(Leaf("enc.pos", (e["encoder_seq"], d), dt,
                           ("normal", 0.02)))
        leaves.append(Leaf("dec_pos", (cfg["max_seq"], d), dt,
                           ("normal", 0.02)))
    else:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    return sorted(leaves, key=lambda x: x.path)


def param_count(cfg: dict) -> int:
    return sum(math.prod(x.shape) for x in param_spec(cfg))


def tree_bytes(cfg: dict) -> int:
    """Bytes of one copy of the parameter (and gradient) tree."""
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in param_spec(cfg))
