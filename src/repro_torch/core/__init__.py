"""repro_torch.core — the ACiS in-network computing engine on PyTorch.

Layering (each module mirrors its :mod:`repro.core` counterpart):
  types       taxonomy + monoids (Type 1/2 algebra)
  ring        hop schedules with per-hop compute over the active mesh
  wire        on-wire codecs (Type 0 streams, Type 2 wire dtypes)
  collectives Type 1/2 collectives, backend = xla | acis
  switchops   SPU instruction registry (plain versions + CUDA kernels)
  compression Type 2 wire datatypes (top-k, int8, PowerSGD factors)
  lookaside   Type 3 look-aside operators (EF, PowerSGD, prefix sum, GCN)
  fused       Type 4 fused collectives (Fig. 5, NAS IS, MapReduce,
              collective matmul)
  program     DAG IR (DagProgram) + the SwitchProgram chain shim
  tracing     traced frontend: programs as plain Python functions
  compiler    Legalize → LowerTopology → Coalesce → FuseHops →
              SelectSchedule → PlaceCGRA → Emit
  executor    ExecutionPlan: dependency edges + concurrent waves
  netmodel    analytic network emulator (a copy of the reference's)
  api         CollectiveEngine: compile(...) and gradient_sync(...)
  topology    hierarchical (pod x data) all-reduce over engine.compile

Usually imported as ``acis``::

    from repro_torch import core as acis
    from repro_torch.mesh import LocalMesh, P

    mesh = LocalMesh({"data": 8})
    fn = acis.make_engine("acis").compile(
        lambda x: acis.reduce(x), mesh, P("data"), P(None))
"""

from repro_torch.core.types import (ADD, MAX, MIN, PROD, AcisType, Monoid,
                                    TYPE1_MONOIDS, TensorSpec, tree_monoid)
from repro_torch.core.api import (BACKENDS, CollectiveConfig,
                                  CollectiveEngine, RecompileReport,
                                  make_engine)
from repro_torch.core.program import (AllGather, AllToAll, Bcast, DagNode,
                                      DagProgram, ErrorFeedback, Map, Node,
                                      Reduce, ReduceScatter, Scan,
                                      SwitchProgram, Wire)
from repro_torch.core.compiler import (AxisSpec, CompiledProgram, Stage,
                                       Topology, compile_program,
                                       compile_rank_local)
from repro_torch.core.executor import ExecutionPlan, build_plan
from repro_torch.core.tracing import (Value, all_gather, all_to_all, bcast,
                                      ef_reduce, masked_reduce, reduce,
                                      reduce_scatter, scan, trace, wire)
from repro_torch.core.tracing import map  # noqa: A004  (traced op, by design)

__all__ = [
    "ADD", "MAX", "MIN", "PROD", "AcisType", "Monoid", "TYPE1_MONOIDS",
    "TensorSpec", "tree_monoid", "BACKENDS", "CollectiveConfig",
    "CollectiveEngine", "RecompileReport", "make_engine", "AllGather", "AllToAll", "Bcast",
    "Map", "Node", "Reduce", "ReduceScatter", "Scan", "SwitchProgram",
    "Wire", "DagNode", "DagProgram", "ErrorFeedback", "AxisSpec",
    "Topology", "CompiledProgram", "Stage", "compile_program",
    "compile_rank_local", "ExecutionPlan", "build_plan",
    "Value", "trace", "map", "reduce", "reduce_scatter", "all_gather",
    "all_to_all", "scan", "bcast", "wire", "ef_reduce", "masked_reduce",
]
