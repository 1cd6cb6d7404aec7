"""Data: datasets, tokenizers, partitioners and batch stacks (port of
``bcfl_tpu/data``)."""

from bcfl_tpu_torch.data.datasets import TextDataset, load_dataset  # noqa: F401
from bcfl_tpu_torch.data.partition import Partitioner  # noqa: F401
from bcfl_tpu_torch.data.pipeline import (  # noqa: F401
    TokenCache,
    central_eval_batches,
    client_batches,
)
from bcfl_tpu_torch.data.tokenizer import (  # noqa: F401
    HashTokenizer,
    HFTokenizerAdapter,
    get_tokenizer,
)
