"""The GQA dense language model on paged KV pools."""
from repro_torch.models.model import LM, ForwardOut, sample_tokens  # noqa: F401
