"""Priority classes and SLO-weighted admission over the tenant-fair queue,
the counterpart of the JAX package's ``serve/policy.py``.

The scheduler's own admission rotates round-robin across the queued
tenants: every class gets the same turn.  :class:`ServePolicy` replaces
the rotation with a **weighted deficit** pop: every admission round each
queued class banks credit equal to its weight, the class with the most
banked credit pops (FIFO within the class) and pays the round's total.
The long-run admission share converges to ``w_c / sum(w)``, and because
credit is banked every round a class waits, no class starves: a weight-1
class among total weight W is admitted at least every ``ceil(W)``
admissions.  Selection is a pure function of the queue and the banked
credits, so scripted traces replay.

Per-class objectives of the ``--slo`` grammar (``ttft_p99[interactive]
=250ms``, an objective over the labeled histogram
``ttft_s[tenant=interactive]``, ``obs/slo.py``) bias the weights live:
while a class's windowed quantile sits over its threshold its weight is
multiplied by ``slo_boost``.

Head of line as in the rotation: the selected class's oldest request is
the only candidate of the round, and because credits settle only on a
successful admission (``on_admit``), a head the engine cannot take yet
keeps its turn.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

__all__ = ["PriorityClass", "ServePolicy", "parse_priority_spec"]

# Weights are clamped above zero: a zero-weight class would bank no
# credit and starve.
_MIN_WEIGHT = 1e-3


class PriorityClass:
    """One named admission class: its weight (relative admission share)
    and the per-class latency objective that boosts it, if any."""

    __slots__ = ("name", "weight", "objective")

    def __init__(self, name: str, weight: float, objective=None):
        if weight <= 0:
            raise ValueError(
                f"priority class {name!r}: weight must be > 0, got {weight}"
            )
        self.name = name
        self.weight = float(weight)
        self.objective = objective

    def __repr__(self) -> str:
        return f"PriorityClass({self.name!r}, weight={self.weight})"


def parse_priority_spec(spec: str) -> dict[str, float]:
    """``--serve-priority``'s grammar, ``interactive=4,batch=1``, into
    ``{class: weight}``; raises ValueError naming the bad clause."""
    weights: dict[str, float] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"priority clause {clause!r} wants <class>=<weight>"
            )
        name, value = (p.strip() for p in clause.split("=", 1))
        if not name:
            raise ValueError(f"priority clause {clause!r}: empty class name")
        try:
            weight = float(value)
        except ValueError:
            raise ValueError(
                f"priority class {name!r}: bad weight {value!r}"
            ) from None
        if weight <= 0:
            raise ValueError(
                f"priority class {name!r}: weight must be > 0, got {weight}"
            )
        if name in weights:
            raise ValueError(f"duplicate priority class {name!r}")
        weights[name] = weight
    if not weights:
        raise ValueError(f"empty priority spec {spec!r}")
    return weights


class ServePolicy:
    """The weighted-deficit admission policy a tier's schedulers share.
    The deficit state lives on each scheduler (``_policy_credits``), so
    replicas stay independent; the scheduler asks :meth:`admit_candidate`
    for its next candidate and reports each admission through
    :meth:`on_admit`."""

    def __init__(
        self,
        weights: dict[str, float] | None = None,
        *,
        default_weight: float = 1.0,
        slo_boost: float = 2.0,
        boost_window_s: float = 60.0,
        aggregator=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {default_weight}"
            )
        if slo_boost < 1.0:
            raise ValueError(
                f"slo_boost must be >= 1 (a penalty would starve the "
                f"burning class), got {slo_boost}"
            )
        self.classes: dict[str, PriorityClass] = {
            name: PriorityClass(name, w)
            for name, w in (weights or {}).items()
        }
        self.default_weight = max(float(default_weight), _MIN_WEIGHT)
        self.slo_boost = float(slo_boost)
        self.boost_window_s = float(boost_window_s)
        self.aggregator = aggregator
        self.clock = clock
        self.admitted_by_class: dict[Any, int] = {}
        self.boosted_admissions = 0
        # The ops endpoint's thread reads snapshot() while the tier admits.
        self._lock = threading.Lock()

    def bind_objectives(self, objectives) -> None:
        """Attach the per-class quantile objectives of the ``--slo`` spec
        (``Objective.cls``); a class named only by an objective joins at
        the default weight."""
        for obj in objectives:
            cls = getattr(obj, "cls", None)
            if cls is None:
                continue
            pc = self.classes.get(cls)
            if pc is None:
                pc = self.classes[cls] = PriorityClass(
                    cls, self.default_weight)
            pc.objective = obj

    def base_weight(self, tenant) -> float:
        pc = self.classes.get(tenant) if tenant is not None else None
        w = pc.weight if pc is not None else self.default_weight
        return max(w, _MIN_WEIGHT)

    def _burning(self, pc: PriorityClass, now: float) -> bool:
        """Whether the class's windowed quantile sits over its threshold."""
        obj = pc.objective
        if obj is None or self.aggregator is None or obj.q is None:
            return False
        hist = self.aggregator.window_hist(obj.metric, self.boost_window_s,
                                           now)
        if hist.count == 0:
            return False
        value = hist.quantile(obj.q)
        return value is not None and value > obj.threshold

    def effective_weight(self, tenant, now: float) -> float:
        """The base weight, times ``slo_boost`` while the class burns."""
        w = self.base_weight(tenant)
        if tenant is not None:
            pc = self.classes.get(tenant)
            if pc is not None and self._burning(pc, now):
                w *= self.slo_boost
        return w

    @staticmethod
    def _credits_of(sched) -> dict:
        credits = getattr(sched, "_policy_credits", None)
        if credits is None:
            credits = sched._policy_credits = {}
        return credits

    def admit_candidate(self, sched):
        """The next request to try on ``sched``: the oldest of the class
        with the most credit after this round's accrual (ties to the
        class first in the queue).  Read-only: credits settle in
        :meth:`on_admit`."""
        queue = sched.queue
        if len(sched._tenant_counts) <= 1:
            return queue[0]
        credits = self._credits_of(sched)
        order: list = []
        seen: set = set()
        for r in queue:
            if r.tenant not in seen:
                seen.add(r.tenant)
                order.append(r.tenant)
        # A departed class forfeits its bank: credit surviving its absence
        # would let a returning burst starve everyone.
        for t in list(credits):
            if t not in seen:
                del credits[t]
        now = sched.clock()
        score = {t: credits.get(t, 0.0) + self.effective_weight(t, now)
                 for t in order}
        index = {t: i for i, t in enumerate(order)}
        best = max(order, key=lambda t: (score[t], -index[t]))
        return next(r for r in queue if r.tenant == best)

    def on_admit(self, sched, request) -> None:
        """Settle the round the admission consumed: every class still
        waiting, and the admitted one, banks its weight; the admitted
        class pays the round's total."""
        credits = self._credits_of(sched)
        present = {request.tenant}
        for r in sched.queue:
            present.add(r.tenant)
        if len(present) <= 1:
            # A one-class round is plain FIFO: banking credit for it would
            # let a lone class pre-pay future contention.
            credits.pop(request.tenant, None)
            boosted = False
        else:
            now = sched.clock()
            w = {t: self.effective_weight(t, now) for t in present}
            for t in present:
                credits[t] = credits.get(t, 0.0) + w[t]
            credits[request.tenant] -= sum(w.values())
            boosted = w[request.tenant] > self.base_weight(request.tenant)
        with self._lock:
            self.admitted_by_class[request.tenant] = (
                self.admitted_by_class.get(request.tenant, 0) + 1)
            if boosted:
                self.boosted_admissions += 1

    def snapshot(self) -> dict[str, Any]:
        """The classes, their weights and burn state, and the admissions."""
        now = self.clock()
        with self._lock:
            admitted = {
                (str(t) if t is not None else "default"): n
                for t, n in sorted(self.admitted_by_class.items(),
                                   key=lambda kv: str(kv[0]))
            }
            boosted = self.boosted_admissions
        return {
            "classes": {
                pc.name: {
                    "weight": pc.weight,
                    "objective": (pc.objective.name
                                  if pc.objective is not None else None),
                    "burning": self._burning(pc, now),
                }
                for pc in sorted(self.classes.values(),
                                 key=lambda pc: pc.name)
            },
            "default_weight": self.default_weight,
            "slo_boost": self.slo_boost,
            "admitted_by_class": admitted,
            "boosted_admissions": boosted,
        }
