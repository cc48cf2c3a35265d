"""sniffer.us_per_hit.live: the mode's handling time per classic and LE
hit, open-loop cells (harness span)."""
from btbench.harness.readings import us_per_hit


def read(run):
    return us_per_hit(run) if run.window.loop == "open" else None
