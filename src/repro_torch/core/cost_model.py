"""Postal cost models — paper §2 Eq. 1 and §3/§4 Eqs. 2-4.

Transcribed from ``src/repro/core/cost_model.py``; the tests hold every
model equal to the JAX package's on every machine of ``MACHINES``.

Use: reproduce the paper's modeled figures (Figs. 7-8) with the Lassen CPU
parameter sets (eager/rendezvous split at 8192 bytes, following [6]). The
machine parameter sets below are the JAX package's, carried over as parity
data only: none describes the H100 or its NVLink, and none chooses a
schedule for the port (``algorithm="auto"`` is not ported). Parameters of
an H100 machine come from measurements on the card, in a later slice.

All times in seconds, sizes in bytes.
"""
from __future__ import annotations

import dataclasses
import math

from .topology import RegionMap, ceil_log, rd_rounds


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """One α/β parameter pair (postal model for a single message class)."""

    alpha: float          # per-message latency [s]
    beta: float           # per-byte transport cost [s/B]

    def msg_cost(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """Eager/rendezvous split (paper §4: >= 8192 bytes uses rendezvous)."""

    eager: LinkParams
    rendezvous: LinkParams
    eager_limit: int = 8192

    def msg_cost(self, nbytes: float) -> float:
        p = self.rendezvous if nbytes >= self.eager_limit else self.eager
        return p.msg_cost(nbytes)


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Local + non-local message classes for one machine (paper Eq. 2).

    The two tiers ARE the split ICI/DCN postal parameters: on the TPU sets
    ``local`` holds (α_ℓ, β_ℓ) for intra-pod ICI and ``nonlocal_`` holds
    (α, β) for the inter-pod DCN. The rendezvous-regime accessors below
    expose them as plain floats — the (α_local, α_nonlocal, β_local,
    β_nonlocal) quadruple ``locality_bruck_phase_split`` and
    ``overlap_model`` price two-tier ('pod','data') schedules with.
    """

    name: str
    local: ProtocolParams       # α_ℓ, β_ℓ  (ICI)
    nonlocal_: ProtocolParams   # α, β      (DCN)

    @property
    def alpha_local(self) -> float:
        return self.local.rendezvous.alpha

    @property
    def beta_local(self) -> float:
        return self.local.rendezvous.beta

    @property
    def alpha_nonlocal(self) -> float:
        return self.nonlocal_.rendezvous.alpha

    @property
    def beta_nonlocal(self) -> float:
        return self.nonlocal_.rendezvous.beta

    def cost(self, *, n_local: int, s_local: float, n_nonlocal: int,
             s_nonlocal: float) -> float:
        """Eq. 2 with per-class mean message size (n messages, s total bytes)."""
        t = 0.0
        if n_local:
            t += n_local * self.local.msg_cost(s_local / n_local)
        if n_nonlocal:
            t += n_nonlocal * self.nonlocal_.msg_cost(s_nonlocal / n_nonlocal)
        return t


def _p(alpha_us: float, bw_gbs: float) -> LinkParams:
    return LinkParams(alpha=alpha_us * 1e-6, beta=1.0 / (bw_gbs * 1e9))


def two_tier_machine(name: str, *, alpha_local_us: float, bw_local_gbs: float,
                     alpha_nonlocal_us: float, bw_nonlocal_gbs: float
                     ) -> MachineParams:
    """MachineParams from a bare (α_local, β_local, α_nonlocal, β_nonlocal)
    quadruple — no eager/rendezvous split (accelerator interconnects have no
    MPI protocol switch). The constructor operators use to fit measured
    ICI/DCN ping-pong numbers into the postal layer."""
    loc = _p(alpha_local_us, bw_local_gbs)
    nl = _p(alpha_nonlocal_us, bw_nonlocal_gbs)
    return MachineParams(
        name=name,
        local=ProtocolParams(eager=loc, rendezvous=loc),
        nonlocal_=ProtocolParams(eager=nl, rendezvous=nl),
    )


# ---------------------------------------------------------------------------
# Parameter sets (parity data, see the module docstring).
#
# LASSEN values approximate the intra-socket / inter-node CPU ping-pong fits
# of Bienz et al. 2021 [6] (paper Fig. 3): sub-µs eager latency through cache
# within a socket vs multi-µs injection over EDR InfiniBand.
# QUARTZ (Intel Xeon E5, Omni-Path) treats the node as the region.
# TPU_V5E maps local→ICI (intra-pod) and non-local→DCN (inter-pod); α from
# typical collective-permute launch overheads, β from 50 GB/s/link ICI and
# ~25 GB/s effective per-chip DCN share.
# ---------------------------------------------------------------------------
LASSEN = MachineParams(
    name="lassen",
    local=ProtocolParams(eager=_p(0.45, 20.0), rendezvous=_p(1.3, 38.0)),
    nonlocal_=ProtocolParams(eager=_p(1.8, 5.0), rendezvous=_p(5.2, 11.5)),
)

QUARTZ = MachineParams(
    name="quartz",
    local=ProtocolParams(eager=_p(0.6, 10.0), rendezvous=_p(1.6, 16.0)),
    nonlocal_=ProtocolParams(eager=_p(1.5, 4.0), rendezvous=_p(4.1, 10.0)),
)

TPU_V5E = two_tier_machine("tpu_v5e", alpha_local_us=1.0, bw_local_gbs=50.0,
                           alpha_nonlocal_us=10.0, bw_nonlocal_gbs=25.0)

# Cross-REGION multi-pod target (the 2×16×16 mesh of launch/mesh.py with
# pods in different buildings/regions): same ICI tier, but the DCN tier
# pays WAN-class launch latency and a thinner effective per-chip share.
# This is the parameter set benchmarks/multipod.py prices the two-tier
# train gather and serve combine under.
TPU_MULTIPOD = two_tier_machine("tpu_multipod",
                                alpha_local_us=1.0, bw_local_gbs=50.0,
                                alpha_nonlocal_us=80.0, bw_nonlocal_gbs=6.0)

MACHINES = {m.name: m for m in (LASSEN, QUARTZ, TPU_V5E, TPU_MULTIPOD)}


# ---------------------------------------------------------------------------
# Closed forms — paper Eqs. 3 and 4.
# ---------------------------------------------------------------------------
def bruck_model(p: int, block_bytes: float, m: MachineParams) -> float:
    """Eq. 3: T = log2(p)·α + (b-1)·β  (all traffic non-local, worst rank)."""
    n = ceil_log(2, p)
    b = block_bytes * p
    s = b - block_bytes / max(p, 1)  # (p-1)/p · b == "b - 1 value" in the paper
    if n == 0:
        return 0.0
    return m.cost(n_local=0, s_local=0.0, n_nonlocal=n, s_nonlocal=s)


def locality_bruck_model(p: int, p_local: int, block_bytes: float,
                         m: MachineParams) -> float:
    """Eq. 4: T = log_{p_ℓ}(r)·α + (b/p_ℓ)·β + (log_{p_ℓ}(r)+1)·α_ℓ·log2(p_ℓ)
                 + (b-1)·β_ℓ.

    The paper's Eq. 4 counts one α_ℓ per *local allgather phase*; each local
    phase is itself a Bruck over p_ℓ ranks, i.e. log2(p_ℓ) messages. We keep
    the per-message accounting (matching the measured implementation); with
    log2(p_ℓ) = 1 both reduce to the paper's form.
    """
    region = RegionMap(p=p, p_local=p_local)
    r = region.n_regions

    # Simulate the (group, active) round sequence exactly — for r a power of
    # p_ℓ this reduces to the paper's closed form (non-local bytes ≈ b/p_ℓ,
    # local bytes = b − 1). For other region counts the allgatherv
    # adaptation applies: the worst rank (lane 1) sends min(group, r−group)
    # chunks per round — the wrapped final round carries only the partial
    # payload its peer is missing, not the entire buffer.
    n_nl = 0
    s_nl = 0.0
    s_l = block_bytes * (p_local - 1)            # initial local allgather
    n_l = ceil_log(2, p_local)
    group = 1
    while group < r:
        n_groups = -(-r // group)
        active = min(p_local, n_groups)
        n_nl += 1
        s_nl += block_bytes * min(group, r - group) * p_local
        # redistribution: (active-1) new chunks of group·p_ℓ blocks each
        # (partial units are zero-padded back to group chunks — DESIGN.md §7)
        s_l += block_bytes * (active - 1) * group * p_local
        n_l += ceil_log(2, p_local)
        group = min(group * active, r)

    return m.cost(n_local=n_l, s_local=s_l, n_nonlocal=n_nl, s_nonlocal=s_nl)


def hierarchical_model(p: int, p_local: int, block_bytes: float,
                       m: MachineParams) -> float:
    """Master-per-region gather → Bruck among masters → broadcast [Träff'06]."""
    region = RegionMap(p=p, p_local=p_local)
    r = region.n_regions
    b = block_bytes * p
    lg_l = ceil_log(2, p_local)
    lg_r = ceil_log(2, r)
    # Master rank dominates: it does the non-local Bruck over region blocks.
    s_nl = block_bytes * p_local * max(r - 1, 0)
    # Master also receives the gather and sends the bcast (full buffer).
    s_l = block_bytes * p_local + b * lg_l  # gather in + bcast out (binomial)
    return m.cost(n_local=2 * lg_l, s_local=s_l, n_nonlocal=lg_r, s_nonlocal=s_nl)


def multilane_model(p: int, p_local: int, block_bytes: float,
                    m: MachineParams) -> float:
    """One lane per local rank [Träff & Hunold'20]: lane Bruck then local AG."""
    region = RegionMap(p=p, p_local=p_local)
    r = region.n_regions
    lg_r = ceil_log(2, r)
    lg_l = ceil_log(2, p_local)
    s_nl = block_bytes * max(r - 1, 0)            # each lane moves its own block
    s_l = block_bytes * r * max(p_local - 1, 0)   # local combine of all lanes
    return m.cost(n_local=lg_l, s_local=s_l, n_nonlocal=lg_r, s_nonlocal=s_nl)


def ring_model(p: int, block_bytes: float, m: MachineParams,
               p_local: int | None = None) -> float:
    """Ring: p-1 neighbor messages; with regions, only the region-boundary
    crossings are non-local (p_ℓ-1 of every p_ℓ steps stay local)."""
    if p <= 1:
        return 0.0
    if p_local:
        region = RegionMap(p=p, p_local=p_local)
        n_nl = region.n_regions if region.n_regions > 1 else 0
        n_l = (p - 1) - n_nl
    else:
        n_nl, n_l = p - 1, 0
    return m.cost(n_local=n_l, s_local=block_bytes * n_l,
                  n_nonlocal=n_nl, s_nonlocal=block_bytes * n_nl)


def max_allreduce_model(p: int, p_local: int, nbytes: float, m: MachineParams,
                        *, structure: str = "locality") -> float:
    """Recursive-doubling max-allreduce (the first phase of the serve decode
    logsumexp combine — no scatter structure exists for non-sum ops).

    structure="locality": rd_rounds(p_ℓ) local rounds then rd_rounds(r)
    non-local rounds, each moving the full (tiny) buffer — matches
    ``collectives.locality_allreduce(op="max")`` including the fold/unfold
    rounds a non-power tier size adds (log2(m) + 2 instead of log2(n)).
    structure="flat": log2(p) rounds over the flat rank; partners at
    distance ≥ p_ℓ cross the region boundary, so only the first
    log2(p_ℓ) rounds stay local.
    """
    region = RegionMap(p=p, p_local=p_local)
    r = region.n_regions
    if p <= 1:
        return 0.0
    if structure == "locality":
        n_l, n_nl = rd_rounds(p_local), rd_rounds(r)
    elif structure == "flat":
        n = ceil_log(2, p)
        n_l = min(ceil_log(2, p_local), n)
        n_nl = n - n_l
    else:
        raise ValueError(f"unknown structure {structure!r}")
    return m.cost(n_local=n_l, s_local=nbytes * n_l,
                  n_nonlocal=n_nl, s_nonlocal=nbytes * n_nl)


# ---------------------------------------------------------------------------
# Overlap terms — the double-buffered prefetch pipeline (DESIGN.md §5).
# ---------------------------------------------------------------------------
# The JAX package defaults ``peak_flops`` to the TPU v5e's bf16 peak; the
# port takes no default, so no TPU rate prices a window on the card.


def locality_bruck_phase_split(p: int, p_local: int, block_bytes: float,
                               m: MachineParams) -> tuple[float, float, float]:
    """Algorithm 2's cost split along the ``allgather_start/finish`` seam.

    Returns ``(t_start_local, t_nonlocal, t_finish_local)``:

    * ``t_start_local``  — local traffic that must run before the last
      non-local round (initial local allgather + intermediate
      redistributions); lives in ``start``;
    * ``t_nonlocal``     — every non-local (DCN) round; lives in ``start``;
    * ``t_finish_local`` — the final local redistribution, deferred to
      ``finish`` at the consumer.

    The three phases are priced separately (per-phase mean message sizes),
    which *refines* Eq. 4's aggregate-mean accounting: their sum is the
    phase-resolved eager cost the overlap model composes from.
    """
    region = RegionMap(p=p, p_local=p_local)
    r, pl = region.n_regions, p_local
    if p <= 1:
        return 0.0, 0.0, 0.0
    if pl <= 1:
        return 0.0, bruck_model(p, block_bytes, m), 0.0

    b = block_bytes
    n_sl, s_sl = ceil_log(2, pl), b * (pl - 1)        # initial local AG
    n_nl = 0
    s_nl = 0.0
    n_fl = s_fl = 0.0
    group = 1
    while group < r:
        n_groups = -(-r // group)
        active = min(pl, n_groups)
        n_nl += 1
        # allgatherv adaptation: the worst lane sends min(group, r−group)
        # chunks (partial on the wrapped final round of non-power counts)
        s_nl += b * min(group, r - group) * pl
        redist_n = ceil_log(2, pl)
        redist_s = b * (active - 1) * group * pl
        if group * active >= r:            # last round: redistribute in finish
            n_fl, s_fl = redist_n, redist_s
        else:
            n_sl += redist_n
            s_sl += redist_s
        group = min(group * active, r)

    t_sl = m.cost(n_local=n_sl, s_local=s_sl, n_nonlocal=0, s_nonlocal=0.0)
    t_nl = m.cost(n_local=0, s_local=0.0, n_nonlocal=n_nl, s_nonlocal=s_nl)
    t_fl = m.cost(n_local=int(n_fl), s_local=s_fl, n_nonlocal=0,
                  s_nonlocal=0.0)
    return t_sl, t_nl, t_fl


@dataclasses.dataclass(frozen=True)
class OverlapCost:
    """Per-layer gather cost under the eager vs prefetched schedule.

    ``t_compute`` is the layer's matmul time — the window the double-buffered
    pipeline slides the ``start`` chain (local prologue + non-local rounds)
    into. The ``finish`` tail always stays exposed at the consumer.
    """

    t_start_local: float
    t_nonlocal: float
    t_finish_local: float
    t_compute: float

    @property
    def exposed_eager(self) -> float:
        """All communication serialized in front of the compute."""
        return self.t_start_local + self.t_nonlocal + self.t_finish_local

    @property
    def exposed_prefetch(self) -> float:
        """start chain hidden behind the previous layer's compute."""
        chain = self.t_start_local + self.t_nonlocal
        return self.t_finish_local + max(0.0, chain - self.t_compute)

    @property
    def exposed_nonlocal_eager(self) -> float:
        return self.t_nonlocal

    @property
    def exposed_nonlocal_prefetch(self) -> float:
        """The chain overlaps compute front-to-back; the non-local rounds sit
        at its tail, so they are the last to become exposed."""
        exposed_chain = max(0.0, self.t_start_local + self.t_nonlocal
                            - self.t_compute)
        return min(self.t_nonlocal, exposed_chain)

    @property
    def hidden(self) -> float:
        return self.exposed_eager - self.exposed_prefetch

    def step_time(self, prefetch: bool) -> float:
        return self.t_compute + (self.exposed_prefetch if prefetch
                                 else self.exposed_eager)


def overlap_model(p: int, p_local: int, block_bytes: float, flops: float,
                  m: MachineParams, *, peak_flops: float) -> OverlapCost:
    """Price one layer's param gather against its compute window.

    ``block_bytes`` is the per-rank shard of the layer's parameters (what
    each rank contributes to the gather); ``flops`` the layer's per-device
    matmul work. This is the (topology, bytes, flops) overlap term the
    tuning policy learns crossovers over.
    """
    t_sl, t_nl, t_fl = locality_bruck_phase_split(p, p_local, block_bytes, m)
    return OverlapCost(t_start_local=t_sl, t_nonlocal=t_nl,
                       t_finish_local=t_fl,
                       t_compute=flops / max(peak_flops, 1.0))


MODELS = {
    "bruck": lambda p, pl, bb, m: bruck_model(p, bb, m),
    "ring": lambda p, pl, bb, m: ring_model(p, bb, m, pl),
    "hierarchical": hierarchical_model,
    "multilane": multilane_model,
    "locality_bruck": locality_bruck_model,
}


def cache_migrate_model(algorithm: str, p: int, p_local: int,
                        block_bytes: float,
                        m: MachineParams | str) -> float:
    """Closed-form price of a KV-slab migration (collectives.cache_migrate).

    Migration is a replication of a sequence-sharded slab over the full
    (outer, local) mesh, so each eligible algorithm prices as its allgather
    closed form — but at slab-sized blocks, where α and β trade off
    differently than for activation payloads (hence its own tuning cell):
    the locality schedule minimizes DCN *messages*, multilane minimizes
    per-rank DCN *bytes*, and GSPMD's flat all-gather ring-decomposes into
    a boundary crossing per region.
    """
    if isinstance(m, str):
        m = MACHINES[m]
    if algorithm == "locality_bruck":
        return locality_bruck_model(p, p_local, block_bytes, m)
    if algorithm == "multilane":
        return multilane_model(p, p_local, block_bytes, m)
    if algorithm == "xla":
        return ring_model(p, block_bytes, m, p_local)
    raise ValueError(f"unknown cache_migrate algorithm {algorithm!r}")


def xla_all_to_all_model(p: int, p_local: int, block_bytes: float,
                         m: MachineParams) -> float:
    """Flat pairwise all-to-all (the XLA baseline): every rank sends one
    ``block_bytes`` message straight to each peer — ``p_ℓ-1`` local,
    ``p - p_ℓ`` crossing the region boundary. ``block_bytes`` is one
    (source, destination)-pair payload, i.e. b/p of the per-rank buffer."""
    if p <= 1:
        return 0.0
    n_nl = p - p_local
    n_l = p_local - 1
    return m.cost(n_local=n_l, s_local=n_l * block_bytes,
                  n_nonlocal=n_nl, s_nonlocal=n_nl * block_bytes)


def locality_all_to_all_model(p: int, p_local: int, block_bytes: float,
                              m: MachineParams) -> float:
    """Two-tier all-to-all (collectives.locality_all_to_all): pod offsets
    o ∈ [1, q) are lane-assigned round-robin, so lane λ ships
    ``n_off(λ) = ceil((q-1-λ)/p_ℓ)`` aggregated p_ℓ²-block DCN messages —
    q-1 per region total vs p_ℓ²·(q-1) pairwise — bracketed by the local
    collect and delivery exchanges. Same unpadded per-rank accounting as
    the ``schedules.locality_all_to_all`` oracle (Eq. 2 over the worst
    rank), so this closed form and ``schedule_cost(mode="postal")`` agree
    exactly. ``block_bytes`` is one (source, destination)-pair payload."""
    region = RegionMap(p=p, p_local=p_local)
    q, pl = region.n_regions, p_local
    if p <= 1:
        return 0.0
    nrounds = -(-(q - 1) // pl) if q > 1 else 0
    n_off = [sum(1 for t in range(nrounds) if t * pl + lam + 1 <= q - 1)
             for lam in range(pl)]
    b = block_bytes
    worst = 0.0
    for lam in range(pl):
        # collect: one message per peer lane that owns any offset
        n_l = sum(1 for o in range(pl) if o != lam and n_off[o] > 0)
        s_l = ((q - 1) - n_off[lam]) * pl * b
        # delivery: own-region block + received slab columns to every lane
        n_l += pl - 1
        s_l += (pl - 1) * (1 + n_off[lam] * pl) * b
        cost = m.cost(n_local=n_l, s_local=s_l, n_nonlocal=n_off[lam],
                      s_nonlocal=n_off[lam] * pl * pl * b)
        worst = max(worst, cost)
    return worst


def all_to_all_model(algorithm: str, p: int, p_local: int, block_bytes: float,
                     m: MachineParams | str) -> float:
    """Closed-form price of a personalized exchange (collectives.all_to_all)
    under the canonical algorithm vocabulary. ``block_bytes`` is one
    (source, destination)-pair payload — the b/p unit the all-to-all
    schedules count blocks in."""
    if isinstance(m, str):
        m = MACHINES[m]
    if algorithm == "locality":
        return locality_all_to_all_model(p, p_local, block_bytes, m)
    if algorithm == "xla":
        return xla_all_to_all_model(p, p_local, block_bytes, m)
    raise ValueError(f"unknown all_to_all algorithm {algorithm!r}")


def checkpoint_replication_model(q: int, shard_bytes: float,
                                 m: MachineParams | str, *,
                                 rf: int = 2) -> float:
    """Price of placing ``rf - 1`` inter-pod replicas of each rank's
    checkpoint shard (checkpoint layout v2, DESIGN.md §10).

    Replica exchange is the degenerate outer phase of the locality-Bruck
    schedule: every rank sends its shard to the lane-aligned rank of pod
    ``(p + k) mod q`` for k = 1..rf-1 — (rf-1) non-local messages of
    ``shard_bytes`` each, zero local traffic (the shard already lives on
    the sender). The same Eq.-2 postal terms as the gather's outer rounds,
    so replication and the training collectives are priced in one currency.
    """
    if isinstance(m, str):
        m = MACHINES[m]
    rf = min(rf, max(q, 1))
    if q <= 1 or rf <= 1:
        return 0.0
    n = rf - 1
    return m.cost(n_local=0, s_local=0.0, n_nonlocal=n,
                  s_nonlocal=n * shard_bytes)


def choose_replication(q: int, shard_bytes: float, m: MachineParams | str, *,
                       budget_s: float | None = None) -> int:
    """Replication factor for checkpoint v2: 2 (one inter-pod replica —
    any single lost pod is recoverable from its neighbour) whenever the
    topology has pods to replicate across and the modeled exchange fits
    ``budget_s``; 1 otherwise. The budget defaults to unconstrained: a
    checkpoint's replica exchange overlaps the async writer, so only an
    explicit operator budget (e.g. a preemption grace window) trims it."""
    if q <= 1:
        return 1
    if budget_s is not None and checkpoint_replication_model(
            q, shard_bytes, m, rf=2) > budget_s:
        return 1
    return 2


def schedule_cost(schedule, m: MachineParams, block_bytes: float,
                  region: RegionMap | None = None, *,
                  mode: str = "round") -> float:
    """Evaluate a generated ``Schedule`` under machine ``m``.

    mode="postal": paper Eq. 2 on the worst single rank's aggregate counts.
    mode="round":  synchronous rounds; each round costs the max over ranks of
                   its per-rank send cost (closer to measured behaviour).
    """
    if mode == "postal":
        best = 0.0
        for (n_l, s_l, n_nl, s_nl) in schedule.per_rank_stats(region).values():
            t = m.cost(n_local=n_l, s_local=s_l * block_bytes,
                       n_nonlocal=n_nl, s_nonlocal=s_nl * block_bytes)
            best = max(best, t)
        return best

    reg = region or schedule.region
    total = 0.0
    for rnd in schedule.rounds:
        worst = 0.0
        per_rank: dict[int, float] = {}
        for s in rnd.sends:
            local = reg.is_local(s.src, s.dst) if reg else False
            proto = m.local if local else m.nonlocal_
            per_rank[s.src] = per_rank.get(s.src, 0.0) + proto.msg_cost(
                len(s.blocks) * block_bytes)
        if per_rank:
            worst = max(per_rank.values())
        total += worst
    return total
