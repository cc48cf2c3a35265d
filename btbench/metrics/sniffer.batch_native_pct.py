"""sniffer.batch_native_pct: the share of the rows handed to
core/batch_decode that its native pass decoded (the port's counter
batch_decode.native_rows over its counter batch_decode.rows), %.  None
for a program without the rows counter; 0 where the native pass never
ran (its library could not be built)."""
from btbench.harness.program import counter


def read(run):
    rows = counter("batch_decode.rows")
    if rows is None:
        return None
    return (counter("batch_decode.native_rows") or 0) / rows * 100.0
