"""Kernels: the least time reckon.py gives the traced slice's attention
windows of at most 32 queries (every decode step, and prefill chunks that
short), over the device time of the decode attention kernels: K2 over the
bf16 cache (attn_decode_tc, attn_decode_f32tc, attn_combine), K4 and K8
over the int8 cache (quant_partial_tc, quant_partial, widening_tc,
quant_merge)."""

from benchmark.readings import roofline_pct

KERNELS = ("attn_decode_tc", "attn_decode_f32tc", "attn_combine", "quant_partial_tc",
           "quant_partial", "widening_tc", "quant_merge")


def read(run):
    return roofline_pct(run, "short_attention", KERNELS)
