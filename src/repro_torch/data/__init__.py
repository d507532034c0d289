from repro_torch.data.synth import SPECS, Dataset, DatasetSpec, load_dataset, synth

__all__ = ["SPECS", "Dataset", "DatasetSpec", "load_dataset", "synth"]
