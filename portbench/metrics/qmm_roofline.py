"""qmm_roofline (%), kernels: the least time the window's packed products
could take on the card (each product the larger of its operations at the
bf16 peak and its bytes at HBM bandwidth), over the device time of the
``qmm_*`` kernels (``qmm_split_a``, ``qmm_tc``, its split-K reduce) in the
trace.  The products are counted from the rows of each call into the
model step: every layer's projections and FFN at the call's rows, the
head at the rows whose logits are taken."""
from portbench import costs

KERNELS = ("qmm_",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.time_of(KERNELS)
    if t <= 0:
        return None
    fam, c = run.cell.family, run.sizes
    least = 0.0
    for s in run.steps:
        for call in s.calls:
            head = 1 if call.kind == "prefill_chunk" else call.rows
            for M, K, N, gated in fam.qmm_products(c, call.rows, head):
                least += costs.least_time(
                    costs.qmm_flops(M, K, N, gated),
                    costs.qmm_bytes(M, K, N, 2, gated))
    return 100.0 * least / t
