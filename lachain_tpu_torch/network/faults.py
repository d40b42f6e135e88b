"""Deterministic fault injection: one seeded plan for every delivery layer.

The port of `lachain_tpu/network/faults.py` (:1-444). A :class:`FaultPlan`
is a seeded, declarative description of an adversarial network: message
loss / delay / duplication / reordering probabilities, link-level
partitions with heal times, and scheduled crash / restart windows. Two
delivery layers of the port execute it:

  * the in-process simulator (`consensus/simulator.py`): the virtual clock
    is the delivered-message count, and lost messages are repaired by
    outbox replay at quiescence;
  * the native engine (`consensus/native_rt.py`): the plan maps onto the
    engine's own knobs (duplicate ppm, reorder mode, muted players), and
    what the engine cannot express is refused.

Every probabilistic decision draws from a `random.Random` seeded from
`(plan.seed, salt)`: a layer that replays the same decision sequence
replays the same faults (HoneyBadgerBFT promises liveness only under
eventual delivery, so the recovery layer must be provoked
deterministically to be testable at all). The draws are the reference's,
draw for draw: one seed gives one fault sequence in both packages.

A :class:`LinkShaper` attached to the plan gives every (region, region)
link a base latency, jitter (with seeded burst windows) and a bandwidth
cap enforced by a per-link pacer; shaped latency comes out of `decide()`
as delays, so the simulator carries it without extra plumbing.

Every injected fault counts in `fault_injected_total{action}`, as in the
reference; `FaultSession.stats`, which the tests and chip_smoke.py read,
counts beside it. The reference's hub frame filters (`TcpFrameFilter`,
`AdversarialRelayFilter`, `KillSwitch`) wait for the port's TCP hub.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple

from ..utils import metrics


@dataclass(frozen=True)
class Crash:
    """Node `node` crashes at `at` and restarts at `restart` (None =
    never). A crashed node neither sends nor processes; on restart it
    rejoins with its in-memory state intact."""

    node: int
    at: float
    restart: Optional[float] = None


@dataclass(frozen=True)
class Partition:
    """Link-level split: traffic between `side_a` and `side_b` is blocked
    from `at` until `heal` (None = never heals). Traffic inside a side and
    nodes on neither side are unaffected."""

    side_a: FrozenSet[int]
    side_b: FrozenSet[int]
    at: float
    heal: Optional[float] = None


@dataclass(frozen=True)
class LinkShape:
    """One directed region->region link's shape, in the layer's clock and
    size units (virtual ticks and nominal frame units in the simulator)."""

    latency: float = 0.0    # one-way base latency
    jitter: float = 0.0     # uniform extra delay in [0, jitter]
    bandwidth: float = 0.0  # size units per clock unit; 0 = uncapped


@dataclass(frozen=True)
class LinkShaper:
    """Seeded WAN link shaping: a per-region-pair latency / jitter /
    bandwidth matrix applied to every frame a FaultSession decides on.

    Nodes stripe over `regions` by position (`regions[node % len]`). Links
    are directed: a missing ordered pair falls back to the reversed pair,
    then to `default` across regions or `intra` inside one. Jitter draws
    land in a burst window with probability `jitter_burst`, where the draw
    is amplified `burst_multiplier` times. The bandwidth cap is a per-link
    serialization pacer: frame k cannot start before frame k-1 finished
    at `bandwidth` units a clock unit, so a flood on a thin link queues."""

    regions: Tuple[str, ...] = ()
    links: Mapping[Tuple[str, str], LinkShape] = field(default_factory=dict)
    default: LinkShape = field(default_factory=LinkShape)
    intra: Optional[LinkShape] = None
    jitter_burst: float = 0.0
    burst_multiplier: float = 4.0

    def region_of(self, node: int) -> str:
        if not self.regions:
            return ""
        return self.regions[node % len(self.regions)]

    def link(self, src: int, dst: int) -> Optional[LinkShape]:
        """The shape governing src->dst traffic, None = unshaped."""
        rs, rd = self.region_of(src), self.region_of(dst)
        shape = self.links.get((rs, rd))
        if shape is None:
            shape = self.links.get((rd, rs))
        if shape is None:
            shape = self.intra if rs == rd else self.default
        return shape

    # -- spec parsing ---------------------------------------------------------

    @staticmethod
    def _dur(s: str) -> float:
        """"40ms" / "1.5s" -> seconds; a bare float passes through (clock
        units of whatever layer runs the plan)."""
        s = s.strip()
        if s.endswith("ms"):
            return float(s[:-2]) / 1000.0
        if s.endswith("s"):
            return float(s[:-1])
        return float(s)

    @staticmethod
    def _rate(s: str) -> float:
        """"4mbps" / "512kbps" -> bytes/second; a bare float passes
        through (size units per clock unit)."""
        s = s.strip().lower()
        if s.endswith("mbps"):
            return float(s[:-4]) * 125_000.0
        if s.endswith("kbps"):
            return float(s[:-4]) * 125.0
        if s.endswith("bps"):
            return float(s[:-3]) / 8.0
        return float(s)

    @classmethod
    def _shape_of(cls, spec: str) -> LinkShape:
        """"LAT[/JITTER][@BW]", e.g. "80ms/8ms@4mbps", "35ms", "3@2"."""
        bw = 0.0
        if "@" in spec:
            spec, _, bw_s = spec.partition("@")
            bw = cls._rate(bw_s)
        lat_s, _, jit_s = spec.partition("/")
        return LinkShape(
            latency=cls._dur(lat_s),
            jitter=cls._dur(jit_s) if jit_s else 0.0,
            bandwidth=bw,
        )

    @classmethod
    def parse(cls, spec: str) -> "LinkShaper":
        """Parse a compact shaper spec, e.g.
        "regions=us,eu,ap,sa;default=80ms/8ms@4mbps;us-eu=35ms;intra=2ms;burst=0.01x8".

        Items are ';'-separated `key=value` pairs: `regions` (positional
        stripes), `default` (cross-region shape), `intra` (same-region
        shape), `burst=PxM` (burst probability P, multiplier M) and
        `A-B=SHAPE` directed region-pair entries."""
        regions: Tuple[str, ...] = ()
        links: Dict[Tuple[str, str], LinkShape] = {}
        default = LinkShape()
        intra: Optional[LinkShape] = None
        burst_p, burst_m = 0.0, 4.0
        for item in spec.split(";"):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            if not val:
                raise ValueError(f"shaper spec item {item!r}: expected key=value")
            key = key.strip()
            if key == "regions":
                regions = tuple(r.strip() for r in val.split(",") if r.strip())
            elif key == "default":
                default = cls._shape_of(val)
            elif key == "intra":
                intra = cls._shape_of(val)
            elif key == "burst":
                p_s, _, m_s = val.partition("x")
                burst_p = float(p_s)
                burst_m = float(m_s) if m_s else 4.0
            elif "-" in key:
                a, _, b = key.partition("-")
                links[(a.strip(), b.strip())] = cls._shape_of(val)
            else:
                raise ValueError(f"shaper spec item {item!r}: unknown key")
        return cls(
            regions=regions,
            links=links,
            default=default,
            intra=intra,
            jitter_burst=burst_p,
            burst_multiplier=burst_m,
        )


@dataclass(frozen=True)
class FaultPlan:
    """Seeded adversarial schedule. All probabilities are per message."""

    seed: int = 0
    drop: float = 0.0        # message silently lost
    duplicate: float = 0.0   # message delivered twice
    delay: float = 0.0       # message deferred
    reorder: float = 0.0     # message swapped with a random queued one
    delay_span: Tuple[float, float] = (1.0, 16.0)  # sampled delay bounds
    partitions: Tuple[Partition, ...] = ()
    crashes: Tuple[Crash, ...] = ()
    shaper: Optional[LinkShaper] = None  # None = flat links

    def session(
        self, clock: Optional[Callable[[], float]] = None, salt: int = 0
    ) -> "FaultSession":
        """A live decision stream for one delivery layer. `clock` gives
        the layer's notion of now (default: seconds since creation); `salt`
        decorrelates per-node streams where each node owns its outbound
        decisions."""
        return FaultSession(self, clock=clock, salt=salt)

    # -- schedule queries -----------------------------------------------------

    def crashed(self, node: int, now: float) -> bool:
        for c in self.crashes:
            if c.node == node and c.at <= now and (
                c.restart is None or now < c.restart
            ):
                return True
        return False

    def partitioned(self, a: int, b: int, now: float) -> bool:
        for p in self.partitions:
            if p.at <= now and (p.heal is None or now < p.heal):
                if (a in p.side_a and b in p.side_b) or (
                    a in p.side_b and b in p.side_a
                ):
                    return True
        return False

    def next_boundary(self, after: float) -> Optional[float]:
        """Earliest schedule edge strictly after `after`: where a quiescent
        simulator jumps its virtual clock, so that partitions heal and
        crashed nodes restart with no traffic in flight."""
        edges: List[float] = []
        for c in self.crashes:
            edges.extend(t for t in (c.at, c.restart) if t is not None)
        for p in self.partitions:
            edges.extend(t for t in (p.at, p.heal) if t is not None)
        future = [t for t in edges if t > after]
        return min(future) if future else None

    # -- spec parsing ---------------------------------------------------------

    @staticmethod
    def parse_crash(spec: str) -> Crash:
        """"NODE@AT[:RESTART]", e.g. "1@400:1200", "2@300"."""
        node_s, _, times = spec.partition("@")
        if not times:
            raise ValueError(f"crash spec {spec!r}: expected NODE@AT[:RESTART]")
        at_s, _, restart_s = times.partition(":")
        return Crash(
            node=int(node_s),
            at=float(at_s),
            restart=float(restart_s) if restart_s else None,
        )

    @staticmethod
    def parse_partition(spec: str) -> Partition:
        """"A,B|C,D@AT[:HEAL]", e.g. "0,1|2,3@300:900"."""
        sides, _, times = spec.partition("@")
        if not times:
            raise ValueError(
                f"partition spec {spec!r}: expected A,B|C,D@AT[:HEAL]"
            )
        a_s, _, b_s = sides.partition("|")
        if not b_s:
            raise ValueError(f"partition spec {spec!r}: missing '|'")
        at_s, _, heal_s = times.partition(":")
        return Partition(
            side_a=frozenset(int(x) for x in a_s.split(",") if x),
            side_b=frozenset(int(x) for x in b_s.split(",") if x),
            at=float(at_s),
            heal=float(heal_s) if heal_s else None,
        )


class FaultSession:
    """One layer's live execution of a FaultPlan: a seeded rng and stats.

    Every decision draws from `random.Random((seed << 20) ^ (salt &
    0xFFFFF))`; a layer that replays the same sequence of `decide()` and
    `reorder_hit()` calls replays the same faults."""

    def __init__(
        self,
        plan: FaultPlan,
        clock: Optional[Callable[[], float]] = None,
        salt: int = 0,
    ):
        self.plan = plan
        if clock is None:
            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0  # noqa: E731
        self._clock = clock
        self.rng = random.Random((plan.seed << 20) ^ (salt & 0xFFFFF))
        self.stats: Dict[str, int] = {
            "dropped": 0,
            "duplicated": 0,
            "delayed": 0,
            "reordered": 0,
            "blocked": 0,   # partition / crash suppression
            "delivered": 0,
            "shaped": 0,    # frames that picked up LinkShaper latency
            "bursts": 0,    # jitter draws that landed in a burst window
        }
        # the bandwidth pacer: per directed link, the clock time its
        # serializer frees up (frame k queues behind frame k-1)
        self._link_free: Dict[Tuple[int, int], float] = {}

    @property
    def now(self) -> float:
        return self._clock()

    # -- schedule state -------------------------------------------------------

    def crashed(self, node: Optional[int]) -> bool:
        return node is not None and self.plan.crashed(node, self.now)

    def partitioned(self, a: Optional[int], b: Optional[int]) -> bool:
        if a is None or b is None:
            return False
        return self.plan.partitioned(a, b, self.now)

    def link_blocked(self, src: Optional[int], dst: Optional[int]) -> bool:
        return self.crashed(src) or self.crashed(dst) or self.partitioned(src, dst)

    def next_boundary(self, after: Optional[float] = None) -> Optional[float]:
        return self.plan.next_boundary(self.now if after is None else after)

    # -- per-message decisions ------------------------------------------------

    def decide(
        self, src: Optional[int], dst: Optional[int], size: int = 1
    ) -> List[float]:
        """The fate of one message on the src->dst link: a list of delivery
        delays, one per copy. `[]` = dropped, `[0.0]` = delivered now,
        `[0.0, 0.0]` = duplicated, `[d]` = delivered after `d` time units.
        Unknown endpoints (None) skip the link-state checks but still roll
        the probabilistic faults. `size` feeds the bandwidth pacer. The
        draws: drop, delay (and its span), duplicate, then the shaper's
        jitter and burst."""
        p = self.plan
        if self.link_blocked(src, dst):
            self.stats["blocked"] += 1
            metrics.inc("fault_injected_total", labels={"action": "blocked"})
            return []
        if p.drop > 0 and self.rng.random() < p.drop:
            self.stats["dropped"] += 1
            metrics.inc("fault_injected_total", labels={"action": "drop"})
            return []
        delays = [0.0]
        if p.delay > 0 and self.rng.random() < p.delay:
            lo, hi = p.delay_span
            delays[0] = lo + self.rng.random() * (hi - lo)
            self.stats["delayed"] += 1
            metrics.inc("fault_injected_total", labels={"action": "delay"})
        if p.duplicate > 0 and self.rng.random() < p.duplicate:
            delays.append(0.0)
            self.stats["duplicated"] += 1
            metrics.inc("fault_injected_total", labels={"action": "dup"})
        shaped = self._shape(src, dst, size)
        if shaped > 0:
            # every copy crosses the same link: shifting them all keeps the
            # duplicate's spacing
            delays = [d + shaped for d in delays]
            self.stats["shaped"] += 1
            metrics.inc("fault_injected_total", labels={"action": "shape"})
        self.stats["delivered"] += 1
        return delays

    def _shape(self, src: Optional[int], dst: Optional[int], size: int) -> float:
        """LinkShaper latency for one frame: base + (burst-amplified)
        jitter + the pacer's serialization and queueing delay; 0.0 on an
        unshaped link."""
        shaper = self.plan.shaper
        if shaper is None or src is None or dst is None or src == dst:
            return 0.0
        link = shaper.link(src, dst)
        if link is None:
            return 0.0
        lat = link.latency
        if link.jitter > 0:
            j = self.rng.random() * link.jitter
            if shaper.jitter_burst > 0 and self.rng.random() < shaper.jitter_burst:
                j *= shaper.burst_multiplier
                self.stats["bursts"] += 1
            lat += j
        if link.bandwidth > 0 and size > 0:
            now = self.now
            start = max(now, self._link_free.get((src, dst), 0.0))
            done = start + size / link.bandwidth
            self._link_free[(src, dst)] = done
            lat += done - now
        return lat

    def reorder_hit(self) -> bool:
        """One roll of the reorder die (the queue's owner does the swap)."""
        if self.plan.reorder <= 0 or self.rng.random() >= self.plan.reorder:
            return False
        self.stats["reordered"] += 1
        metrics.inc("fault_injected_total", labels={"action": "reorder"})
        return True
