"""The program's own spans and counters, read where the window left
them: the port's process-global Metrics (utils/metrics.py), which the
harness resets before the window and which nothing touches between the
window's end and the readers.  Self time, the span log (filled only
while a profiler records, so only in a traced run) and the sniffer's
spans are newer than the first benchmark: a program without one reads
None, never 0."""
from __future__ import annotations

__all__ = ["stage_self", "counter", "starts"]


def _metrics():
    from gr_bluetooth_tpu_torch.utils.metrics import metrics
    return metrics


def stage_self(name: str) -> tuple | None:
    """(calls, self seconds) of the program's stage `name`."""
    st = _metrics().stages.get(name)
    if st is None or not st.calls or not hasattr(st, "self_s"):
        return None
    return st.calls, st.self_s


def counter(name: str) -> int | None:
    """The program's counter `name`, None where it never counted."""
    return _metrics().counters.get(name) or None


def starts(name: str) -> list:
    """Start times (perf_counter seconds) of every span `name` in the
    program's span log, in the order the spans closed."""
    log = getattr(_metrics(), "spans", None) or []
    return [t0 for n, t0, _ in log if n == name]
