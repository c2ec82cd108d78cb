"""Funnel: device milliseconds a group of the funnel's kernels
(`kernels.kmer_funnel`, csrc/kmer_funnel.cu: amb_scatter, funnel,
funnel_eval, funnel_chase, funnel_replay, the unpacks, and the sets queued
before them), in the traced stretch."""

from benchmark import devtrace

KERNELS = ("funnel_kernel", "funnel_eval_kernel", "funnel_chase_kernel", "funnel_replay_kernel",
           "amb_scatter_kernel", "unpack_codes_kernel", "unpack_amb_kernel")


def read(ctx):
    return devtrace.op_ms(ctx.trace, KERNELS)
