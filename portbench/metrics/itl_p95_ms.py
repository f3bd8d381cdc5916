"""itl_p95_ms (ms): 95th percentile of every gap between consecutive
tokens of one request, both visible inside the window."""
from portbench.harness import itl_gaps, percentile


def read(run):
    p = percentile(itl_gaps(run), 95)
    return None if p is None else 1e3 * p
