from repro_torch.data.pipeline import IndexStream
from repro_torch.data.synth import SPECS, Dataset, DatasetSpec, load_dataset, synth
from repro_torch.data.tokens import lm_batch, zipf_tokens

__all__ = ["SPECS", "Dataset", "DatasetSpec", "IndexStream", "lm_batch", "load_dataset",
           "synth", "zipf_tokens"]
