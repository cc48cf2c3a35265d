"""sniffer.us_per_hit: the mode's handling time per classic and LE hit,
closed-loop cells (harness span)."""
from btbench.harness.readings import us_per_hit


def read(run):
    return us_per_hit(run) if run.window.loop == "closed" else None
