"""The kernels' launch counters, by name.

Each kernel wrapper of ops/ adds one to its counter (an attribute of the
wrapper function) where it launches its kernel, and nowhere else. This
module names them all, so that a caller can zero them before a run and read
them after it: chip_smoke.py does, and each rank of a multi-process run
logs its own at the end (cli.py).
"""

from __future__ import annotations


def counters() -> dict:
    """(wrapper, attribute) holding each kernel's launch count, by name."""
    from llamago_tpu_torch.ops import attention, cache_write, kernels
    from llamago_tpu_torch.ops import lab_kernels as lk

    return {"dequant_matmul": (kernels.dequant_matmul, "launches"),
            "dequant_matmul_q4": (kernels.dequant_matmul, "launches_q4"),
            "dequant_matmul_tc": (kernels.dequant_matmul, "launches_tc"),
            "dequant_matmul_decode_tc": (kernels.dequant_matmul, "launches_decode_tc"),
            "dequant_matmul_f32_tc": (kernels.dequant_matmul, "launches_f32_tc"),
            "dequant_matmul_f32_decode_tc": (kernels.dequant_matmul, "launches_f32_decode_tc"),
            "w4x8_matmul_a8": (kernels.w4x8_matmul, "launches_a8"),
            "w4x8_matmul_stream": (kernels.w4x8_matmul, "launches_stream"),
            "w4x8_matmul_tc": (kernels.w4x8_matmul, "launches_tc"),
            "w4x8_matmul_f32_tc": (kernels.w4x8_matmul, "launches_f32_tc"),
            "dequant_matmul_so": (kernels.dequant_matmul_so, "launches"),
            "dequant_matmul_so_decode_tc": (kernels.dequant_matmul_so, "launches_decode_tc"),
            "dequant_matmul_so_f32_decode_tc": (kernels.dequant_matmul_so,
                                                "launches_f32_decode_tc"),
            "dequant_matmul_so_tc": (kernels.dequant_matmul_so, "launches_tc"),
            "dequant_matmul_so_f32_tc": (kernels.dequant_matmul_so, "launches_f32_tc"),
            "flash_attention": (attention.flash_attention, "launches"),
            "flash_attention_decode_tc": (attention.flash_attention, "launches_decode_tc"),
            "flash_attention_decode_f32tc": (attention.flash_attention,
                                             "launches_decode_f32tc"),
            "flash_attention_prefill": (attention.flash_attention, "launches_prefill"),
            "flash_attention_prefill_tc": (attention.flash_attention, "launches_prefill_tc"),
            "flash_attention_prefill_f32tc": (attention.flash_attention,
                                              "launches_prefill_f32tc"),
            "fused_rms_norm": (kernels.fused_rms_norm, "launches"),
            "cache_append_quant": (cache_write.cache_append_quant, "launches"),
            "flash_attention_quant_i8dot": (attention.flash_attention_quant,
                                            "launches_i8dot"),
            "flash_attention_quant_i8dot_tc": (attention.flash_attention_quant,
                                               "launches_i8dot_tc"),
            "flash_attention_quant_widening": (attention.flash_attention_quant,
                                               "launches_widening"),
            "flash_attention_quant_widening_tc": (attention.flash_attention_quant,
                                                  "launches_widening_tc"),
            "lab_i4_matmul": (lk.i4_matmul, "launches"),
            "lab_bf16_dequant_matmul": (lk.bf16_dequant_matmul, "launches"),
            "lab_w4a8_matmul": (lk.w4a8_matmul, "launches"),
            "lab_w8a8_matmul": (lk.w8a8_matmul, "launches"),
            "lab_fulltk_matmul": (lk.fulltk_matmul, "launches"),
            "lab_bitcast_i4_matmul": (lk.bitcast_i4_matmul, "launches"),
            "lab_bitcast_i4_i8dot": (lk.bitcast_i4_i8dot, "launches"),
            "lab_probe": (lk.probe, "launches"),
            "lab_w16_matmul": (lk.w16_matmul, "launches")}


def reset() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
