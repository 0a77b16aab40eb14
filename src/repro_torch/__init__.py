"""repro_torch — ACiS (complex processing in the switch fabric) on PyTorch.

The port of the JAX package :mod:`repro` to PyTorch and CUDA: all ranks
of a mesh live in one tensor on one device (:mod:`repro_torch.mesh`),
switch programs compile through the same pass pipeline
(:mod:`repro_torch.core`), and the hot per-hop combine and the bucket
arena pack are hand-written CUDA kernels (:mod:`repro_torch.kernels`).
Nothing here imports JAX or the reference package.
"""

import torch

#: The ops ATen computes through MKL's VML for f32 and f64: the
#: ``IMPLEMENT_VML_MKL`` entries of ``ATen/cpu/vml.h``.
_VML_OPS = (torch.acos, torch.asin, torch.atan, torch.cos, torch.erf,
            torch.erfc, torch.erfinv, torch.exp, torch.log, torch.log10,
            torch.log2, torch.sin, torch.sqrt, torch.tan, torch.tanh,
            torch.trunc)


def _set_up_vml() -> None:
    """Set up MKL's vector math functions on this thread, once.

    torch's CPU kernels run tanh, exp, log and the other ops below
    through MKL's VML, which sets each function up on its first call.
    When that first call comes from several OpenMP threads at once (a
    tensor of at least two 2,048-element grains), a thread can run it on
    a provisional path — VML's EP accuracy on its AVX2 code — and return
    values off by up to 5.2e-5 relative for its chunk, while every later
    call is right (ROADMAP.md F4: the simulator's first 8-thread
    ``tanh`` in a worker process, on a loaded host).  One call of each on
    one element, here, sets them up before any parallel use."""
    for dtype in (torch.float32, torch.float64):
        one = torch.full((1,), 0.5, dtype=dtype)
        for op in _VML_OPS:
            op(one)


_set_up_vml()
