"""The port's examples that build a model against the reference's: the
batched serving demo and the end-to-end trainer (the collective demos are
in ``tests/test_torch_examples.py``, whose helpers this file shares).

* ``serve_batched``: both examples on the smoke config, the port's
  params the reference's own (``interop.params_from_reference``).  In
  f32 every completion of the three bursts equal token for token and the
  decode program's name, count and ``explain()`` columns equal; in the
  example's bf16 the process-wide program cache's programs, hits and
  misses equal (both caches cleared first).
* ``train_e2e``: its loss curve is held to the reference's in
  ``tests/test_torch_train.py`` (the 30-step smoke helper, one reference
  run); here each backend runs the twin's ``main`` at that size through
  its own descent assert, on the mesh the reference's mesh maps to.
"""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.serve import PROGRAM_CACHE as JCACHE
from repro_torch import configs, interop
from repro_torch.serve import PROGRAM_CACHE

from test_torch_examples import Through, columns, load

F32 = dict(dtype="float32", param_dtype="float32")


def test_serve_exports_the_references_names():
    import repro.serve
    import repro_torch.serve
    assert sorted(repro_torch.serve.__all__) == sorted(repro.serve.__all__)


def _serve_pair(capsys, dtype: dict):
    """Both examples' ``main`` on the smoke config with ``dtype``, the
    port on the reference's params, each process-wide program cache
    cleared first: (the reference's bursts' completions, its stdout, its
    cache's stats; the twin's result and stdout)."""
    captured, done = {}, []
    ref = load("serve_batched")

    class RefModel(ref.Model):
        def init(self, key):
            captured["params"] = super().init(key)
            return captured["params"]

    class RefEngine(ref.ServeEngine):
        def run_to_completion(self, *a, **kw):
            done.append(super().run_to_completion(*a, **kw))
            return done[-1]

    ref.configs = Through(jconfigs, get_smoke=lambda name: dataclasses.replace(
        jconfigs.get_smoke(name), **dtype))
    ref.Model, ref.ServeEngine = RefModel, RefEngine
    JCACHE.clear()
    ref.main()
    want = capsys.readouterr().out
    want_cache = JCACHE.stats()

    twin = load("torch_serve_batched")

    class PortModel(twin.Model):
        def init(self, generator, device=None):
            return interop.params_from_reference(captured["params"], device)

    twin.Model = PortModel
    PROGRAM_CACHE.clear()
    got = twin.main(["--smoke"], device="cpu", cfg=dataclasses.replace(
        configs.get_smoke("acis-100m"), **dtype))
    return done, want, want_cache, got, capsys.readouterr().out


def test_serve_batched_matches_reference_in_f32(capsys):
    """Every completion of the three bursts, token for token, and the
    decode program (in bf16 the greedy picks of random weights meet
    near-ties the two packages round apart)."""
    done, want, _, got, text = _serve_pair(capsys, F32)
    for burst, completions in zip(("plain", "compiled", "replica2"), done):
        assert got[burst]["completions"] == {c.rid: c.tokens
                                             for c in completions}, burst
    assert got["replica2_new_compiles"] == 0
    dp = got["decode_program"]
    assert f"decode tick runs {dp['calls_per_tick']}× {dp['name']}:" in want
    assert columns(text) == columns(want) and len(columns(text)) == 1


def test_serve_batched_program_cache_matches_reference(capsys):
    """The shared cache's programs, hits and misses, as both examples
    print them, on the example's own bf16 config (the reference builds a
    tick's programs at bf16 avals whatever the params' dtype, so in f32
    its trace compiles a second program)."""
    _, want, want_cache, got, text = _serve_pair(capsys, {})
    assert PROGRAM_CACHE.stats() == want_cache      # after decode_programs
    assert got["replica2_new_compiles"] == 0
    lines = [ln for ln in want.splitlines()
             if "program cache" in ln or "new compiles" in ln]
    assert len(lines) == 2 and all(ln in text for ln in lines)


@pytest.mark.parametrize("backend", ["acis_compressed", "acis", "xla",
                                     "acis_hierarchical"])
def test_train_e2e_twin_descends_on_every_backend(backend):
    """The smoke curve's size: 30 steps of 8 x 32 (the reference's own
    descent bar of 0.1); the acis backends on ``{"data": 4}`` (the
    reference's acis step splits the batch over ``data`` only), ``xla``
    on ``{"data": 4, "model": 2}``, ``acis_hierarchical`` flat (no pod
    axis, as in the reference)."""
    got = load("torch_train_e2e").main(
        ["--smoke", "--steps", "30", "--seq", "32", "--backend", backend],
        device="cpu")
    assert got["mesh"] == ({"data": 4, "model": 2} if backend == "xla"
                           else {"data": 4})
    assert got["nll_last"] < got["nll_first"] - 0.1
    assert [s for s, _, _ in got["curve"]] == list(range(30))
    assert int(got["state"].step) == 30
    if backend == "xla":
        assert "sync_program" not in got
        return
    kinds = got["sync_program"].stage_kinds()
    assert "allreduce" in kinds or "ef_allreduce" in kinds
    assert {a for a in got["sync_program"].stage_axes() if a} == {"data"}
    assert ("wire_mb_int16" in got) == (backend == "acis_compressed")
    assert got["arena_bytes"] > 0
