"""hop_adc_fs_roofline: percent of its bound at which csrc/hop_adc_fs.cu ran in
the window (device trace; bytes and operations counted by roofline.hop_adc_fs_cost)."""

from perfbench import readers, roofline

ENTRY = ("repro_torch.kernels.ops", "hop_adc_fs")


def read(rec):
    return readers.kernel_roofline(rec, ENTRY, "hop_adc_fs", roofline.hop_adc_fs_cost)
