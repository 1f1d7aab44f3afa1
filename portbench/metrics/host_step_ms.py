"""host_step_ms: the median host duration of the serving call's `adm.step`
ranges in the traced window (one step's forward and update as the host runs
them under the profiler: Python, dispatch and launches).  It reads the
host's pace while the card keeps ahead of it; where the launch queue fills,
launches block and it reads the card's.  Nothing is read where the trace
holds no such span (a program without it)."""
import statistics

SPAN = "adm.step"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    durs = [h["dur"] for h in t.host if h["name"] == SPAN and t.t0 <= h["ts"] <= t.t1]
    if not durs:
        return None
    return statistics.median(durs) * 1e-3
