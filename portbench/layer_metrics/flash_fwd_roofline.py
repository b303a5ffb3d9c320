"""Share of its roofline that the flash forward reaches (``flash_fwd_kernel``
or, where the configuration keeps the log-sum-exp for its backward, as the
preset's ``flash_backward='pallas'`` does in serving too,
``flash_fwd_lse_kernel``, both of ``csrc/flash_attention.cu``): the least
time of its launches (``counts.kernels.flash_bytes_flops``, each a block's
attention at its stage's tokens and mask), over their device time, in
percent.  Every launch of a unit counts alike: the records kept stand for
the launches made."""

from ..counts.kernels import bound, flash_bytes_flops

KERNEL = "flash_fwd(?:_lse)?"


def read(ctx):
    records = ctx.kernels(KERNEL)
    calls = ctx.counts.get("flash_fwd_calls") or []
    if not records or not calls:
        return None
    dtype = ctx.counts["dtype"]
    least = 0.0
    for r in records:
        kind = "fwd" if "flash_fwd_lse" in r.name else "fwd_plain"
        least += sum(bound(*flash_bytes_flops(*c, dtype, kind), dtype)[0]
                     for c in calls) / len(calls)
    spent = sum(r.end_ns - r.start_ns for r in records) * 1e-9
    return 100.0 * least / spent
