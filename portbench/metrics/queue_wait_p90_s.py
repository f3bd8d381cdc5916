"""queue_wait_p90_s (s), engine: 90th percentile of the program's
``EngineStats.queue_wait_s`` (enqueue to first admission) of the
requests sent inside the window."""
from portbench.harness import percentile


def read(run):
    waits = run.stats.queue_wait_s
    return percentile([waits[r.spec.index] for r in run.requests
                       if run.inside(r.sent) and r.spec.index in waits], 90)
