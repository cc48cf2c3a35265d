"""sniffer.batch_native_pct.live: sniffer.batch_native_pct in the cells
that report result_latency_p95_ms, %."""
from btbench.harness.spec import load_reader

read = load_reader("sniffer.batch_native_pct")
