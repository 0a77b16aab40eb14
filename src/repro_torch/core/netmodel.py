"""Analytic network emulator — the paper's own evaluation methodology.

The paper's direct-network results (§V.A) come from an emulation with
"(1) the same volume of traffic in the network links, (2) an identical
number of network hops, and (3) an accurate overhead of the accelerator",
parameterized by Table II.  This module rebuilds that emulator so the
benchmark suite can reproduce the paper's figures (3-6) and so the
framework can *predict* collective latency when choosing schedules
(latency-vs-bandwidth crossover, Type 2/3 compression payoff).

Table II constants (measured by the authors on their testbed):
    MPI overhead        14.8 µs      (per software message)
    max network BW      95.9 Gb/s    (11.99 GB/s)
    PCIe latency        0.9 µs
    FPGA-FPGA link      0.44 µs      (Aurora)
    min port-to-port    52 ns
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.cgra.device import CGRADevice, PAPER_CGRA, placement_rate


@dataclasses.dataclass(frozen=True)
class NetParams:
    mpi_overhead: float = 14.8e-6
    bw: float = 95.9e9 / 8            # bytes/s
    pcie: float = 0.9e-6
    fpga_link: float = 0.44e-6
    port: float = 52e-9
    host_bw: float = 6e9 # endpoint compute stream (B/s)
    py_overhead: float = 15e-6        # MPI4py per-collective python cost
    # The in-switch accelerator is a *device*, not a rate constant: the
    # old accel_clock/accel_width pair is now the device's line rate at
    # II = 1, and a mapped stage's placement (repro_torch.cgra.mapper) derives
    # the rate it actually sustains.
    device: CGRADevice = PAPER_CGRA

    @property
    def accel_clock(self) -> float:   # back-compat spelling
        return self.device.clock_hz

    @property
    def accel_width(self) -> int:     # back-compat spelling
        return self.device.lane_bytes


PAPER = NetParams()


def accel_rate(p: NetParams, placement=None) -> float:
    """In-switch compute throughput (bytes/s) for a stage.

    With a :class:`~repro_torch.cgra.device.Placement` this is what the mapped
    op-graph sustains (``line_rate / II``); without one it is the
    device's line rate — the bare Type-1 fixed-function combine, the only
    compute allowed to be costed without a placement.  A host-fallback
    placement raises (cost the detour via :func:`host_fallback_time`).
    """
    return placement_rate(placement, p.device)


def host_fallback_time(m: int, p: NetParams = PAPER) -> float:
    """Cost of bouncing a stage's compute to the host NIC-side CPU.

    The payload detours over PCIe (out and back), pays one software
    message injection, and streams through the endpoint at ``host_bw`` —
    what a stage costs when its body does not fit the switch CGRA.
    """
    return 2 * p.pcie + p.mpi_overhead + m / p.host_bw

# ---------------------------------------------------------------------------
# Two-tier link parameters (multi-pod topologies).
#
# The intra-pod tier ("ici") is the paper's testbed fabric.  The inter-pod
# tier ("dci") models the thin links where a multi-pod system's flows
# converge: ~10× less bandwidth than ICI (the usual DCI/ICI provisioning
# ratio on pod-scale systems) and longer-reach links with ~5× the per-hop
# latency.  SelectSchedule costs each compiled stage against the tier of
# the axis it traverses; LowerTopology places wire compression on the DCI
# hop only, where those bytes are the bottleneck.
# ---------------------------------------------------------------------------

DCI_BW_RATIO = 0.1        # inter-pod bandwidth as a fraction of intra-pod
DCI_HOP_RATIO = 5.0       # inter-pod per-hop latency multiplier

ICI = PAPER
DCI = dataclasses.replace(
    PAPER,
    bw=PAPER.bw * DCI_BW_RATIO,
    fpga_link=PAPER.fpga_link * DCI_HOP_RATIO,
)

TIERS = {"ici": ICI, "dci": DCI}


def torus_hops(n: int) -> int:
    """Average hop count of a 3D-torus of n nodes (paper emulates 3D torus)."""
    side = max(round(n ** (1 / 3)), 1)
    return max(3 * (side // 2), 1)


# ---------------------------------------------------------------------------
# baseline MPI collectives (endpoint compute, passive network)
# ---------------------------------------------------------------------------

def mpi_allgather(n: int, m: int, p: NetParams = PAPER) -> float:
    """Bruck-style latency term + ring bandwidth term."""
    return math.ceil(math.log2(max(n, 2))) * p.mpi_overhead \
        + (n - 1) * m / p.bw


def mpi_allreduce(n: int, m: int, p: NetParams = PAPER) -> float:
    """Recursive-doubling latency + ring RS/AG bandwidth (MPI hybrid)."""
    return 2 * math.ceil(math.log2(max(n, 2))) * p.mpi_overhead \
        + 2 * (n - 1) / n * m / p.bw \
        + m / p.host_bw                       # endpoint reduction compute


def mpi_bcast(n: int, m: int, p: NetParams = PAPER) -> float:
    """Binomial tree."""
    return math.ceil(math.log2(max(n, 2))) * (p.mpi_overhead + m / p.bw)


def mpi_gather(n: int, m: int, p: NetParams = PAPER) -> float:
    """Binomial tree latency; root link carries all (n-1) payloads."""
    return math.ceil(math.log2(max(n, 2))) * p.mpi_overhead \
        + (n - 1) * m / p.bw


def mpi_alltoall(n: int, m: int, p: NetParams = PAPER) -> float:
    return (n - 1) * (p.mpi_overhead + (m / n) / p.bw)


# ---------------------------------------------------------------------------
# ACiS collectives (in-switch processing)
# ---------------------------------------------------------------------------

def _acis_base(n: int, p: NetParams) -> float:
    """Fixed path cost: host→NIC→fabric→…→host, once per collective."""
    return 2 * p.pcie + torus_hops(n) * (p.fpga_link + p.port) \
        + p.mpi_overhead  # one software injection (ExaMPI transport)


def acis_allgather(n: int, m: int, p: NetParams = PAPER) -> float:
    # replication happens in the fabric; each link still carries (n-1)m/n·…
    return _acis_base(n, p) + (n - 1) * m / p.bw \
        + (n - 1) * (p.fpga_link + p.port)


def acis_allreduce(n: int, m: int, p: NetParams = PAPER, *,
                   placement=None) -> float:
    """In-network reduction: messages merge as they travel — each link
    carries each byte once; combine runs at the placed rate in the CGRA
    (line rate when the combine is the bare Type-1 adder)."""
    stream = m / p.bw + m / accel_rate(p, placement)
    return _acis_base(n, p) + stream + math.ceil(
        math.log2(max(n, 2))) * (p.fpga_link + p.port)


def acis_bcast(n: int, m: int, p: NetParams = PAPER) -> float:
    return _acis_base(n, p) + m / p.bw + math.ceil(
        math.log2(max(n, 2))) * (p.fpga_link + p.port)


def acis_gather(n: int, m: int, p: NetParams = PAPER) -> float:
    return _acis_base(n, p) + (n - 1) * m / p.bw


def acis_alltoall(n: int, m: int, p: NetParams = PAPER) -> float:
    return _acis_base(n, p) + (n - 1) * (m / n) / p.bw \
        + (n - 1) * (p.fpga_link + p.port)


# ---------------------------------------------------------------------------
# fused chains (Type 4): intermediate communication is bypassed
# ---------------------------------------------------------------------------

def mpi4py_allgather_op_allgather(n: int, m: int,
                                  p: NetParams = PAPER) -> float:
    """Paper Fig. 5 baseline: AG → host prefix-sum → AG(v), plus python."""
    ag = mpi_allgather(n, m, p) + p.py_overhead
    op = (n * m) / p.host_bw + p.py_overhead
    return 2 * ag + op


def acis_allgather_op_allgather(n: int, m: int, p: NetParams = PAPER, *,
                                placement=None) -> float:
    """Fused: one traversal; the op streams through the CGRA in-flight.
    The paper's runtime is itself Python-based (§V: "the runtime and MPI
    support are based on Python"), so the fixed software cost appears once
    on this path too."""
    return _acis_base(n, p) + p.py_overhead + 2 * p.mpi_overhead \
        + (n - 1) * m / p.bw \
        + (n * m) / accel_rate(p, placement) \
        + (n - 1) * (p.fpga_link + p.port)


def mpi_allreduce_then_alltoall(n: int, m_hist: int, m_keys: int,
                                p: NetParams = PAPER) -> float:
    return mpi_allreduce(n, m_hist, p) + mpi_alltoall(n, m_keys, p)


# ---------------------------------------------------------------------------
# ring-schedule cost model (consumed by the compiler's SelectSchedule pass)
# ---------------------------------------------------------------------------

def ring_allreduce_time(n: int, m: int, p: NetParams = PAPER, *,
                        latency_optimal: bool = False,
                        placement=None) -> float:
    """Predicted wall time of one ring all-reduce of ``m`` bytes per rank.

    ``latency_optimal=True``: n-1 hops of full-size messages (one combine
    per hop) — few sequential hops, each carrying the whole payload.
    ``latency_optimal=False``: RS∘AG — 2(n-1) hops of m/n bytes each
    (bandwidth-optimal; right for large payloads).  ``placement`` is the
    stage's CGRA placement; the per-hop combine runs at its sustained
    rate (line rate for the bare Type-1 adder).
    """
    if n <= 1:
        return 0.0
    hop = p.fpga_link + p.port
    rate = accel_rate(p, placement)
    if latency_optimal:
        return (n - 1) * (m / p.bw + hop) + (n - 1) * m / rate
    return 2 * (n - 1) * ((m / n) / p.bw + hop) \
        + (n - 1) * (m / n) / rate


def ring_crossover_bytes(n: int, p: NetParams = PAPER) -> float:
    """Payload size at which the latency- and bandwidth-optimal rings tie.

    Below this, the (n-1)-hop full-message ring wins (per-hop latency
    dominates); above it, the chunked RS∘AG ring wins (wire bytes dominate).
    Derived from :func:`ring_allreduce_time` with the combine term dropped:
    t_lat < t_bw  ⇔  m (1 - 2/n) / bw < hop  for n > 2.

    Pass the link tier actually traversed (``ICI`` vs ``DCI``): a thin
    inter-pod wire pushes the crossover an order of magnitude lower.
    """
    if n <= 2:
        return float("inf")  # schedules move identical bytes; latency ties
    hop = p.fpga_link + p.port
    return hop * p.bw / (1.0 - 2.0 / n)


# Fraction of a bucket collective's time the fixed per-collective cost
# (the hop walk) is allowed to be: the Coalesce pass sizes its flat-buffer
# gradient buckets so the 2(n-1) ring hops are amortized down to this
# share of the bandwidth term.
BUCKET_OVERHEAD_FRACTION = 0.05

# Floor/ceiling for derived bucket sizes (unknown topologies get the
# floor — roughly the classic DDP bucket scale).
MIN_BUCKET_BYTES = 1 << 20
MAX_BUCKET_BYTES = 64 << 20


def bucket_bytes(n: Optional[int], p: NetParams = PAPER, *,
                 overhead_fraction: float = BUCKET_OVERHEAD_FRACTION) -> int:
    """Coalesce bucket size for an ``n``-rank ring on link tier ``p``.

    Solves ``2(n-1)·hop ≤ f · 2(n-1)/n · m/bw`` for ``m``: the payload at
    which the fixed hop walk of one more collective costs at most
    ``overhead_fraction`` of its streaming time.  Sits well above
    :func:`ring_crossover_bytes`, so bucketized stages are always in the
    bandwidth-optimal regime.  Unknown ``n`` falls back to the floor.
    """
    if n is None or n <= 1:
        return MIN_BUCKET_BYTES
    hop = p.fpga_link + p.port
    m = n * hop * p.bw / overhead_fraction
    return int(min(max(m, MIN_BUCKET_BYTES), MAX_BUCKET_BYTES))


def ring_reduce_scatter_time(n: int, m: int, p: NetParams = PAPER, *,
                             placement=None) -> float:
    """Chunked ring RS: n-1 hops of m/n bytes, one combine per hop."""
    if n <= 1:
        return 0.0
    hop = p.fpga_link + p.port
    return (n - 1) * ((m / n) / p.bw + hop) \
        + (n - 1) * (m / n) / accel_rate(p, placement)


def ring_all_gather_time(n: int, m: int, p: NetParams = PAPER) -> float:
    """Chunked ring AG: n-1 hops of m/n bytes, no combine."""
    if n <= 1:
        return 0.0
    hop = p.fpga_link + p.port
    return (n - 1) * ((m / n) / p.bw + hop)


def batched_ring_times(n: int, sizes, p: NetParams = PAPER, *,
                       latency_optimal: bool = False
                       ) -> tuple[float, float]:
    """(separate, batched) wall time of k same-axis ring all-reduces.

    ``separate`` launches one ring per payload — k full hop walks;
    ``batched`` is ONE ring over the stacked payload (the Coalesce
    ``batch_rings`` rewrite), paying the walk once.  The gap is the
    launch amortization: ``(k-1) · hops · (fpga_link + port)`` plus the
    per-launch bandwidth remainder of ragged chunking.
    """
    sizes = [float(m) for m in sizes]
    separate = sum(ring_allreduce_time(n, m, p,
                                       latency_optimal=latency_optimal)
                   for m in sizes)
    batched = ring_allreduce_time(n, sum(sizes), p,
                                  latency_optimal=latency_optimal)
    return separate, batched


def bucketed_collective_times(kind: str, n: int, sizes,
                              p: NetParams = PAPER) -> tuple[float, float]:
    """(separate, bucketed) wall time of k same-axis RS or AG leaves.

    ``kind`` ∈ {"reduce_scatter", "allgather"}.  The Coalesce RS/AG
    bucket runs one collective over the concatenated payload; like the
    allreduce buckets, the saving is the k-1 amortized hop walks.  For
    AG, ``sizes`` are per-rank *input* shard bytes (the model's AG kind
    convention: the gathered payload is ``n · m``).
    """
    sizes = [float(m) for m in sizes]
    if kind == "reduce_scatter":
        sep = sum(ring_reduce_scatter_time(n, m, p) for m in sizes)
        tot = ring_reduce_scatter_time(n, sum(sizes), p)
    elif kind == "allgather":
        sep = sum(ring_all_gather_time(n, n * m, p) for m in sizes)
        tot = ring_all_gather_time(n, n * sum(sizes), p)
    else:
        raise ValueError(f"bucketed_collective_times: unknown {kind!r}")
    return sep, tot


def hierarchical_allreduce_time(d: int, pods: int, m: int, *,
                                inner: NetParams = ICI,
                                outer: NetParams = DCI) -> float:
    """RS(inner, d ranks) → AR(outer, pods ranks, m/d shard) → AG(inner).

    The compiled LowerTopology schedule: the thin inter-pod tier only ever
    carries 1/d of the payload, vs a flat AR over d·pods ranks pushing
    2·(dp-1)/dp of every byte through the DCI links too.
    """
    shard = m / max(d, 1)
    return ring_reduce_scatter_time(d, m, inner) \
        + ring_allreduce_time(pods, shard, outer) \
        + ring_all_gather_time(d, m, inner)


# Fraction of the histogram reduction left exposed past the key exchange
# in the fused AR+A2A schedule: the shared ring cannot start combining
# until the first key chunk lands (pipeline fill), which the emulation
# charges as a 10% un-overlapped remainder of the reduction time.
FUSED_EXPOSED_FRACTION = 0.1


def acis_fused_allreduce_alltoall(n: int, m_hist: int, m_keys: int,
                                  p: NetParams = PAPER, *,
                                  placement=None) -> float:
    """Shared schedule: the histogram hops ride the key exchange; the
    reduction is free behind the (larger) key traffic.

    This is the *application-level* emulator term (one per-collective
    software/PCIe base cost included), paired against the MPI baseline in
    the paper figures.  The per-stage compiled-plan model —
    :func:`stage_time` / the dataplane simulator — uses
    :func:`fused_ar_a2a_ring_time`, the bare shared-traversal walk.
    """
    keys = acis_alltoall(n, m_keys, p)
    hist_exposed = max(0.0, acis_allreduce(n, m_hist, p,
                                           placement=placement) - keys)
    return keys + FUSED_EXPOSED_FRACTION * hist_exposed \
        + m_hist / accel_rate(p, placement)


def fused_ar_a2a_ring_time(n: int, m_hist: int, m_keys: int,
                           p: NetParams = PAPER, *,
                           placement=None) -> float:
    """Shared-ring traversal of the fused AR+A2A stage, hop-exact.

    Mirrors the dataplane simulator's walk (one traversal, n-1 hops):
    every hop forwards one key chunk (``m_keys/n``) *plus* the whole
    histogram (the reduction rides every hop), and combines the
    histogram at the placed rate.  No per-collective software base cost
    — per-stage models are composed by :func:`program_time`, which is
    also what the simulator validates.
    """
    if n <= 1:
        return 0.0
    hop = p.fpga_link + p.port
    chunk = m_keys / n + m_hist
    return (n - 1) * (hop + chunk / p.bw
                      + m_hist / accel_rate(p, placement))


# ---------------------------------------------------------------------------
# per-stage analytic model (PlaceCGRA / dataplane-simulator comparison)
# ---------------------------------------------------------------------------

# stage kinds whose pipe runs a fused MAP body: costing them needs a real
# placement — there is deliberately no constant-rate default for MAP work.
_MAP_KINDS = {"map", "map+allreduce", "map+reduce_scatter",
              "allgather+map"}


def stage_time(kind: str, n: int, m: int, p: NetParams = PAPER, *,
               placement=None, schedule: str = "",
               codec_ratio: float = 1.0,
               m_parts: Optional[tuple] = None) -> float:
    """Predicted wall time of one emitted stage.

    ``kind`` is a :class:`~repro_torch.core.compiler.Stage` kind, ``n`` the
    size of the axis it traverses, ``m`` the per-rank payload bytes
    *before* wire coding (``codec_ratio`` scales what actually travels).
    ``m_parts`` splits ``m`` per operand for multi-input stages whose
    traversal treats the operands asymmetrically (the fused AR+A2A pair:
    ``(m_hist, m_keys)``); without it an even split is assumed.

    ``placement`` is the stage's CGRA mapping.  Stages that stream a
    fused MAP body **require** one — the old flat ``accel_clock *
    accel_width`` constant is gone, and asking for a MAP-stage time
    without saying where the map runs raises instead of silently
    assuming line rate.  A :class:`~repro_torch.cgra.device.HostFallback`
    placement is costed as the PCIe + MPI host detour.
    """
    if kind in _MAP_KINDS and placement is None:
        raise ValueError(
            f"stage kind {kind!r} streams a fused map: pass its CGRA "
            "placement (or HostFallback) — there is no constant-rate "
            "default for MAP compute")
    fallback = placement is not None and not getattr(placement, "fits",
                                                     True)
    wire = m * codec_ratio
    hop = p.fpga_link + p.port
    lat = schedule == "latency"
    pl = None if fallback else placement

    if kind == "map":
        return host_fallback_time(m, p) if fallback \
            else m / accel_rate(p, pl)
    if kind in ("allreduce", "map+allreduce", "batched_allreduce"):
        # a batched_allreduce IS one ring over the stacked payload — the
        # amortization (k-1 launch walks saved) is already in m being the
        # sum of the merged payloads
        if fallback:
            return host_fallback_time(m, p) + mpi_allreduce(n, wire, p)
        return ring_allreduce_time(n, wire, p, latency_optimal=lat,
                                   placement=pl)
    if kind in ("reduce_scatter", "map+reduce_scatter"):
        if fallback:
            return host_fallback_time(m, p) \
                + ring_reduce_scatter_time(n, wire, p)
        return ring_reduce_scatter_time(n, wire, p, placement=pl)
    if kind == "allgather+map":
        # m is the per-rank *input* shard; each of the n-1 hops forwards
        # one full shard (the gathered payload is n*m), and the hop map
        # runs once per forwarded shard
        gather = ring_all_gather_time(n, n * m, p)
        if fallback:
            return host_fallback_time(m, p) + gather
        return gather + (n - 1) * m / accel_rate(p, pl)
    if kind == "allgather":
        return ring_all_gather_time(n, n * m, p)
    if kind == "alltoall":
        return (n - 1) * ((m / n) / p.bw + hop) if n > 1 else 0.0
    if kind == "bcast":
        return math.ceil(math.log2(max(n, 2))) * (m / p.bw + hop)
    if kind == "scan":
        rounds = math.ceil(math.log2(max(n, 2)))
        if fallback:
            return host_fallback_time(m, p) + rounds * (m / p.bw + hop)
        return rounds * (m / p.bw + hop + m / accel_rate(p, pl))
    if kind == "scan+allgather":
        t = stage_time("scan", n, m, p, placement=placement)
        return t + ring_all_gather_time(n, n * m, p)
    if kind == "delivered":
        # purely local: what the lossy wire delivered of this rank's own
        # contribution — no collective happens
        return host_fallback_time(m, p) if fallback \
            else m / accel_rate(p, pl)
    if kind == "ef_allreduce":
        # shared-scale path: a tiny latency-ring scale exchange plus the
        # quantized (≈ half-width) payload on the RS∘AG walk
        if fallback:
            return host_fallback_time(m, p) + mpi_allreduce(n, m, p)
        compress = m / accel_rate(p, pl)
        scale = ring_allreduce_time(n, max(m // 256, 4), p,
                                    latency_optimal=True)
        return compress + scale + ring_allreduce_time(n, m // 2, p)
    if kind == "allreduce+alltoall":
        # the pair's per-rank payloads: the stamped per-operand split
        # (hist, keys), or an even split of the summed m as a fallback
        m_hist, m_keys = (m_parts if m_parts and len(m_parts) == 2
                          else (m // 2, m // 2))
        if fallback:
            return host_fallback_time(m, p) \
                + mpi_allreduce_then_alltoall(n, m_hist, m_keys, p)
        return fused_ar_a2a_ring_time(n, m_hist, m_keys, p, placement=pl)
    raise ValueError(f"unknown stage kind {kind!r}")


# ---------------------------------------------------------------------------
# per-stage linear decomposition (repro_torch.tune.fit least-squares design)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageTerms:
    """:func:`stage_time` decomposed over the fittable unknowns.

    For the ring-schedule kinds the stage time is linear in the link
    parameters::

        t = hops · (fpga_link + port)
          + wire_bytes / bw
          + compute_bytes / accel_rate(p, placement)
          + detours · (2·pcie + mpi_overhead)
          + host_bytes / host_bw
          + mpi_msgs · mpi_overhead

    which is what lets :mod:`repro_torch.tune.fit` recover per-tier latency and
    bandwidth (and the host-fallback detour) from recorded traces by
    least squares.  ``compute_bytes`` and ``mpi_msgs`` are charged at
    their prior rates by the fit (the CGRA device is not a wire).
    """

    hops: float = 0.0
    wire_bytes: float = 0.0
    compute_bytes: float = 0.0
    detours: float = 0.0
    host_bytes: float = 0.0
    mpi_msgs: float = 0.0

    def __add__(self, other: "StageTerms") -> "StageTerms":
        return StageTerms(*(a + b for a, b in
                            zip(dataclasses.astuple(self),
                                dataclasses.astuple(other))))

    def time(self, p: NetParams, placement=None) -> float:
        """Re-assemble the stage time under ``p`` — matches
        :func:`stage_time` exactly for every decomposable kind."""
        hop = p.fpga_link + p.port
        return self.hops * hop + self.wire_bytes / p.bw \
            + (self.compute_bytes / accel_rate(p, placement)
               if self.compute_bytes else 0.0) \
            + self.detours * (2 * p.pcie + p.mpi_overhead) \
            + self.host_bytes / p.host_bw \
            + self.mpi_msgs * p.mpi_overhead


def stage_time_terms(kind: str, n: int, m: int, *, schedule: str = "",
                     codec_ratio: float = 1.0, fallback: bool = False,
                     m_parts: Optional[tuple] = None
                     ) -> Optional[StageTerms]:
    """The :class:`StageTerms` decomposition of :func:`stage_time`.

    Mirrors the per-kind formulas above term by term (a unit test pins
    the two against each other); returns None for kinds with no linear
    form.  ``fallback=True`` selects the host-detour branch of the kind.
    """
    T = StageTerms
    wire = m * codec_ratio
    L = math.ceil(math.log2(max(n, 2)))
    ring = max(n - 1, 0)

    def host(extra_host: float = 0.0) -> StageTerms:
        # host_fallback_time: 2·pcie + mpi + m/host_bw
        return T(detours=1.0, host_bytes=m + extra_host)

    def mpi_ar(mm: float) -> StageTerms:
        # mpi_allreduce: 2L software messages + ring RS/AG wire + endpoint
        return T(wire_bytes=2 * ring / max(n, 1) * mm, host_bytes=mm,
                 mpi_msgs=2 * L)

    if kind == "map":
        return host() if fallback else T(compute_bytes=m)
    if kind in ("allreduce", "map+allreduce", "batched_allreduce"):
        if fallback:
            return host() + mpi_ar(wire)
        if n <= 1:
            return T()
        if schedule == "latency":
            return T(hops=ring, wire_bytes=ring * wire,
                     compute_bytes=ring * wire)
        return T(hops=2 * ring, wire_bytes=2 * ring * (wire / n),
                 compute_bytes=ring * (wire / n))
    if kind in ("reduce_scatter", "map+reduce_scatter"):
        rs = T() if n <= 1 else T(hops=ring, wire_bytes=ring * (wire / n),
                                  compute_bytes=ring * (wire / n))
        return host() + rs if fallback else rs
    if kind == "allgather":
        return T() if n <= 1 else T(hops=ring, wire_bytes=ring * m)
    if kind == "allgather+map":
        ag = T() if n <= 1 else T(hops=ring, wire_bytes=ring * m)
        return host() + ag if fallback else ag + T(compute_bytes=ring * m)
    if kind == "alltoall":
        return T() if n <= 1 else T(hops=ring, wire_bytes=ring * (m / n))
    if kind == "bcast":
        return T(hops=L, wire_bytes=L * m)
    if kind == "scan":
        base = T(hops=L, wire_bytes=L * m)
        return host() + base if fallback \
            else base + T(compute_bytes=L * m)
    if kind == "scan+allgather":
        sc = stage_time_terms("scan", n, m, fallback=fallback)
        return sc + stage_time_terms("allgather", n, m)
    if kind == "delivered":
        return host() if fallback else T(compute_bytes=m)
    if kind == "ef_allreduce":
        if fallback:
            return host() + mpi_ar(m)
        s = max(m // 256, 4)
        half = m // 2
        scale = T() if n <= 1 else T(hops=ring, wire_bytes=ring * s,
                                     compute_bytes=ring * s)
        rs_ag = T() if n <= 1 else T(hops=2 * ring,
                                     wire_bytes=2 * ring * (half / n),
                                     compute_bytes=ring * (half / n))
        return T(compute_bytes=m) + scale + rs_ag
    if kind == "allreduce+alltoall":
        m_hist, m_keys = (m_parts if m_parts and len(m_parts) == 2
                          else (m // 2, m // 2))
        if fallback:
            # mpi_allreduce(hist) + mpi_alltoall(keys)
            return host() + mpi_ar(m_hist) \
                + T(wire_bytes=ring * (m_keys / n), mpi_msgs=ring)
        return T() if n <= 1 else T(
            hops=ring, wire_bytes=ring * (m_keys / n + m_hist),
            compute_bytes=ring * m_hist)
    return None


def plan_stage_terms(st, topo=None) -> Optional[tuple]:
    """``(tier, terms, placement)`` for one emitted plan stage, or None.

    The per-stage analogue of :func:`plan_stage_time` that
    :mod:`repro_torch.tune.fit` builds its least-squares design rows from:
    ``tier`` names the link whose (hop, 1/bw) columns the stage loads,
    ``placement`` fixes the compute rate the fit charges at its prior.
    """
    ir = getattr(st, "ir", None)
    m = getattr(ir, "bytes_in", None)
    if m is None:
        return None
    n = 1
    if st.axis:
        if topo is None or topo.size(st.axis) is None:
            return None
        n = topo.size(st.axis)
    placement = st.placement
    if st.kind in _MAP_KINDS and placement is None:
        return None
    fallback = placement is not None and not getattr(placement, "fits",
                                                     True)
    ratio = 1.0
    for nd in getattr(ir, "nodes", ()):
        codec = nd.op.codec
        if getattr(codec, "wire_ratio", 1.0) != 1.0:
            ratio = float(codec.wire_ratio)
    terms = stage_time_terms(st.kind, n, m, schedule=st.schedule,
                             codec_ratio=ratio, fallback=fallback,
                             m_parts=getattr(ir, "bytes_parts", None))
    if terms is None:
        return None
    return _tier_of(st.axis, topo), terms, (None if fallback else placement)


# ---------------------------------------------------------------------------
# program-level cost (ExecutionPlan critical path with per-tier overlap)
# ---------------------------------------------------------------------------

# How much of a *non-critical* concurrent stage's time the fabric hides
# when independent stages of one wave run together.  Keyed by the link
# tier of the stage being overlapped: different-axis rings use disjoint
# links, but every rank *injects* into all of its rings through one
# port, so the wire-serialization share of a concurrent stage stays
# exposed while propagation and in-switch compute hide.  Purely local
# (axis-less) compute streams behind whatever communication is in
# flight.  1.0 = the stage is entirely hidden behind the wave's critical
# path, 0.0 = it serializes (the old sum-of-stages model).
#
# The ici/dci fractions are CALIBRATED, not priors: fitted by
# :func:`fit_tier_overlap` against the dataplane simulator's overlapped
# ``SimReport.t_end`` (which charges injection contention at the shared
# port) across the cross-axis points of ``benchmarks/execplan.py``
# (`python -m benchmarks.run` prints the current fit as
# ``execplan_tier_overlap_calibration``).  The pre-calibration priors
# were ici 0.9 / dci 0.6 — far too optimistic for bandwidth-bound
# stages, whose time is mostly injection serialization the shared port
# cannot hide.
TIER_OVERLAP = {"ici": 0.29, "dci": 0.13, "local": 1.0}


def plan_stage_time(st, topo=None, p: NetParams = PAPER) -> Optional[float]:
    """:func:`stage_time` for one emitted stage of an ExecutionPlan.

    ``st`` duck-types :class:`repro_torch.core.compiler.Stage` (``kind``,
    ``axis``, ``schedule``, ``placement``, and an ``ir`` carrying
    ``bytes_in`` — raw per-rank payload bytes — plus the fused nodes'
    wire codec).  ``topo`` duck-types :class:`repro_torch.core.compiler.
    Topology` for per-axis ring sizes and link tiers.  Returns None when
    the payload or the axis size is unknown.
    """
    ir = getattr(st, "ir", None)
    m = getattr(ir, "bytes_in", None)
    if m is None:
        return None
    n = 1
    net = p
    if st.axis:
        if topo is None or topo.size(st.axis) is None:
            return None
        n = topo.size(st.axis)
        net = topo.net(st.axis)
    ratio = 1.0
    for nd in getattr(ir, "nodes", ()):
        codec = nd.op.codec
        if getattr(codec, "wire_ratio", 1.0) != 1.0:
            ratio = float(codec.wire_ratio)
    try:
        return stage_time(st.kind, n, m, net, placement=st.placement,
                          schedule=st.schedule, codec_ratio=ratio,
                          m_parts=getattr(ir, "bytes_parts", None))
    except ValueError:
        return None


def _tier_of(axis: str, topo) -> str:
    if not axis:
        return "local"
    spec = topo.spec(axis) if topo is not None else None
    return spec.tier if spec is not None else "ici"


def _wave_terms(plan, topo=None, p: NetParams = PAPER):
    """Per wave: ``(base, exposed)`` — the longest per-axis serialized
    chain, and every *other* axis's chain keyed by its link tier (the
    part a tier's overlap fraction can hide).  The shared decomposition
    under :func:`program_time` and :func:`fit_tier_overlap`."""
    terms = []
    for wave in plan.waves:
        per_axis: dict[str, float] = {}
        for i in wave:
            st = plan.stages[i]
            t = plan_stage_time(st, topo, p)
            if t:
                per_axis[st.axis] = per_axis.get(st.axis, 0.0) + t
        if not per_axis:
            continue
        longest_axis = max(per_axis, key=per_axis.get)
        exposed: dict[str, float] = {}
        for ax, t in per_axis.items():
            if ax != longest_axis:
                tier = _tier_of(ax, topo)
                exposed[tier] = exposed.get(tier, 0.0) + t
        terms.append((per_axis[longest_axis], exposed))
    return terms


def program_time(plan, topo=None, p: NetParams = PAPER, *,
                 overlap: Optional[dict] = None) -> float:
    """Predicted wall time of a whole compiled program's ExecutionPlan.

    Within each wave, stages traversing *different* axes use disjoint
    links and overlap; stages sharing an axis serialize on its ring.
    The wave costs its longest per-axis chain plus, for every other
    axis, the un-hidden ``(1 - TIER_OVERLAP[tier])`` remainder of that
    axis's chain.  Summed over waves this is a critical-path cost:
    always ≥ the longest single stage and ≤ the plain sum of stage
    times (the pre-plan model).

    Stages whose payload or axis size is unknown contribute zero — cost
    what the model can see rather than refusing the whole program.
    """
    ov = dict(TIER_OVERLAP)
    if overlap:
        ov.update(overlap)
    total = 0.0
    for base, exposed in _wave_terms(plan, topo, p):
        total += base
        for tier, t in exposed.items():
            total += (1.0 - ov.get(tier, 1.0)) * t
    return total


def fit_tier_overlap(samples, *, tiers=("ici", "dci"),
                     p: NetParams = PAPER) -> dict:
    """Least-squares calibration of :data:`TIER_OVERLAP` from measured
    overlapped end-to-end latencies.

    ``samples`` is an iterable of ``(plan, topo, t_measured)`` — e.g. the
    dataplane simulator's ``SimReport.t_end`` for programs whose waves
    hold cross-axis stages.  :func:`program_time` is linear in the
    per-tier exposure ``x_t = 1 - overlap_t``::

        t = Σ_w base_w + Σ_t x_t · B_t ,  B_t = Σ_w exposed_w[t]

    so the fit solves the normal equations of ``Σ_i (Σ_t B_it x_t -
    (t_i - A_i))²`` over the requested tiers, clamping each overlap into
    [0, 1].  Tiers with no exposure in any sample keep their current
    :data:`TIER_OVERLAP` value.  Returns ``{tier: fitted_overlap}``
    (does not mutate the module constant).
    """
    samples = [(plan, topo, t_meas,
                list(_wave_terms(plan, topo, p)))
               for plan, topo, t_meas in samples]
    live = list(tiers)
    while True:
        # assemble the normal equations over the currently fittable
        # tiers; any other tier's exposure is charged at its current
        # TIER_OVERLAP value and folded into the base
        k = len(live)
        gram = [[0.0] * k for _ in range(k)]
        rhs = [0.0] * k
        for _, _, t_meas, terms in samples:
            base = 0.0
            b = [0.0] * k
            for wave_base, exposed in terms:
                base += wave_base
                for t_name, t_val in exposed.items():
                    if t_name in live:
                        b[live.index(t_name)] += t_val
                    else:
                        base += (1.0 - TIER_OVERLAP.get(t_name, 1.0)) \
                            * t_val
            r = t_meas - base
            for i in range(k):
                rhs[i] += b[i] * r
                for j in range(k):
                    gram[i][j] += b[i] * b[j]
        # a tier with no exposure, or whose column is (nearly) linearly
        # dependent on the others, cannot be identified from these
        # samples: drop it from the fit (it keeps its current value)
        # and RE-solve — silently zeroing its variable while reporting
        # the old constant would make the returned fit inconsistent
        # with the equations it was solved from
        dead = next((t for i, t in enumerate(live)
                     if gram[i][i] <= 0.0), None)
        if dead is None:
            a = [row[:] + [rhs[i]] for i, row in enumerate(gram)]
            singular = None
            for col in range(k):
                piv = max(range(col, k), key=lambda r_: abs(a[r_][col]))
                scale = max(abs(gram[col][col]), 1e-30)
                if abs(a[piv][col]) < 1e-9 * scale:
                    singular = live[col]
                    break
                a[col], a[piv] = a[piv], a[col]
                for r_ in range(k):
                    if r_ != col and a[r_][col]:
                        f = a[r_][col] / a[col][col]
                        a[r_] = [x - f * y for x, y in zip(a[r_], a[col])]
            dead = singular
        if dead is not None:
            live.remove(dead)
            if live:
                continue
            return {t: TIER_OVERLAP[t] for t in tiers
                    if t in TIER_OVERLAP}
        fitted = dict(TIER_OVERLAP)
        for i, t in enumerate(live):
            x = a[i][-1] / a[i][i]
            fitted[t] = min(max(1.0 - x, 0.0), 1.0)
        return {t: fitted[t] for t in tiers if t in fitted}
