"""hop_adc_roofline: percent of its bound at which csrc/hop_adc.cu ran in the
window (device trace; bytes and operations counted by roofline.hop_adc_cost)."""

from perfbench import readers, roofline

ENTRY = ("repro_torch.kernels.ops", "hop_adc")


def read(rec):
    return readers.kernel_roofline(rec, ENTRY, "hop_adc_kernel", roofline.hop_adc_cost)
