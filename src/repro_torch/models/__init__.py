"""The GQA dense language model on paged KV pools."""
