"""attn_roofline (%), kernels: the least time of the window's attention
(``paged_decode`` over each decoding sequence's valid rows, and
``flash_prefill`` over each chunk's causally visible keys, binary8 K and V
at one byte, f32 q in and out), over the device time of the
``paged_decode_piece``, ``piece::merge`` and ``flash_prefill_kernel``
kernels in the trace."""
from portbench import costs

KERNELS = ("paged_decode", "piece::merge", "flash_prefill")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.time_of(KERNELS)
    if t <= 0:
        return None
    c = run.sizes
    H, kv, dh, L = c["n_heads"], c["n_kv"], c["head_dim"], c["n_layers"]
    page = int(run.cell.traffic["engine"]["page_size"])
    least = 0.0
    for s in run.steps:
        if s.dec_lens:
            least += L * costs.least_time(
                sum(costs.decode_attn_flops(n, H, dh) for n in s.dec_lens),
                costs.decode_attn_bytes(s.dec_lens, kv, H, dh, 1, page))
        for ch in s.chunks:
            least += L * costs.least_time(
                costs.prefill_attn_flops(ch.rows, ch.offset, H, dh),
                costs.prefill_attn_bytes(ch.rows, ch.offset, kv, H, dh, 1))
    return 100.0 * least / t
