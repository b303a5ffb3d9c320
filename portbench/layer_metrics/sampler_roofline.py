"""Share of its roofline that the fused DDPM reverse loop reaches (the wide
kernel ``ddpm_sampler_wide_kernel`` or the register kernel
``ddpm_sampler_kernel``): the least time of one loop
(``counts.kernels.sampler_bytes_flops``) over the mean device time of its
records, in percent."""

from ..counts.kernels import bound, sampler_bytes_flops

KERNEL = "ddpm_sampler(?:_wide)?"


def read(ctx):
    records = ctx.kernels(KERNEL)
    if not records:
        return None
    dtype = ctx.counts["dtype"]
    least = bound(*sampler_bytes_flops(*ctx.counts["sampler_call"], dtype),
                  dtype)[0]
    spent = sum(r.end_ns - r.start_ns for r in records) * 1e-9
    return 100.0 * least * len(records) / spent
