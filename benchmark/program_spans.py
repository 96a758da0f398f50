"""What the system records about itself in the traced window, for the
per-layer readers (`benchmark/metrics/`): its spans and counters
(`srfdet3d_torch.utils.profiling`), kept while a torch.profiler session
is open, so they cover exactly the traced frames or steps.  The second
file of the harness that imports the system (after port.py).

A span's record gives its name, its parent, its top-level span (a
`predict` frame or a `train_step` step), its stream ms (CUDA events: the
card's time from reaching its start to reaching its end) and the
counters' deltas over it.  Every value here is an amount a top-level
span: the sum over the traced ones divided by their number.  A system
without the record (no `profiling.recorded`), a run off the card (no
stream ms) or a window with no such span gives None."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

# the system's span prefix in the profiler's trace
PREFIX = "srfdet/"


def records() -> Optional[list]:
    """The system's span record of the traced window, or None."""
    try:
        from srfdet3d_torch.utils import profiling
        recorded = profiling.recorded
    except (ImportError, AttributeError):
        return None
    return recorded()


def _tops(recs: list, top: str) -> List[int]:
    return [i for i, r in enumerate(recs)
            if r.parent is None and r.name == top]


def _under(recs: list, i: int, tops: set) -> bool:
    """Does span i lie inside one of the spans `tops`?"""
    p = recs[i].parent
    while p is not None:
        if p in tops:
            return True
        p = recs[p].parent
    return False


def stream_ms(top: str, name: str, recs: Optional[list] = None
              ) -> Optional[float]:
    """Stream ms of the spans `name` inside the top-level spans `top`,
    summed, a top-level span."""
    recs = records() if recs is None else recs
    if not recs:
        return None
    tops = _tops(recs, top)
    spans = [r for i, r in enumerate(recs)
             if r.name == name and _under(recs, i, set(tops))]
    if not tops or not spans or any(r.stream_ms is None for r in spans):
        return None
    return sum(r.stream_ms for r in spans) / len(tops)


def counted(top: str, counter: str, recs: Optional[list] = None
            ) -> Optional[float]:
    """Counter `counter`'s delta over the top-level spans `top`, a span."""
    recs = records() if recs is None else recs
    if not recs:
        return None
    tops = _tops(recs, top)
    if not tops:
        return None
    return sum(recs[i].counts.get(counter, 0) for i in tops) / len(tops)


def idle_inside_pct(trace, name: str) -> Optional[float]:
    """Share (%) of the card's idle time in the traced window during which
    the host is inside a range `name` of the profiler's trace (its
    `user_annotation` ranges, on the kernels' clock)."""
    inside = sorted((ts, ts + dur) for ts, dur, n in trace.host
                    if n == name)
    if not inside:
        return None
    gaps, prev = [], trace.t0
    for s, e in trace.intervals():
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    idle = sum(e - s for s, e in gaps)
    if idle <= 0.0:
        return None
    covered, j = 0.0, 0
    for gs, ge in gaps:
        while j < len(inside) and inside[j][1] <= gs:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < ge:
            covered += min(ge, inside[k][1]) - max(gs, inside[k][0])
            k += 1
    return 100.0 * covered / idle


def idle_by_span(trace) -> Dict[str, float]:
    """The card's idle seconds in the traced window by the innermost of
    the system's ranges the host was in at each instant (`(none)`:
    outside every one: the caller's copies and loop)."""
    ranges = sorted((ts, ts + dur, n[len(PREFIX):]) for ts, dur, n in
                    trace.host if n.startswith(PREFIX))
    gaps, prev = [], trace.t0
    for s, e in trace.intervals():
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    # elementary segments between every boundary; the innermost range at
    # a segment is the open one that began last (the ranges nest)
    cuts = sorted({t for g in gaps for t in g} |
                  {t for s, e, _ in ranges for t in (s, e)})
    out: Dict[str, float] = {}
    g = r = 0
    active: List[tuple] = []
    for a, b in zip(cuts, cuts[1:]):
        while r < len(ranges) and ranges[r][0] <= a:
            active.append(ranges[r])
            r += 1
        active = [x for x in active if x[1] > a]
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            name = max(active)[2] if active else "(none)"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def main(argv=None) -> int:
    """`benchmark/run.py`'s run of a cell with `--trace 1` (the same
    arguments), which also prints, after the result, the card's idle ms a
    frame or step by the system's innermost span (`idle_by_span`):

        python3 -m benchmark.program_spans --workload <cell> --seed <n> \
            --seconds <s>
    """
    import json

    from benchmark import run, trace as tracing
    kept = []
    profile = tracing.profile

    def keep(fn):
        kept.append(profile(fn))
        return kept[-1]
    tracing.profile = keep
    rc = run.main(list(argv if argv is not None else sys.argv[1:]) +
                  ["--trace", "1"])
    if rc or not kept:
        return rc or 1
    frames = sum(1 for r in records() or () if r.parent is None)
    idle = {k: 1e3 * v / max(frames, 1)
            for k, v in idle_by_span(kept[0]).items()}
    print(json.dumps({"frames": frames, "idle_ms_by_span": idle}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
