"""Image tokenizer of the port.  The text side and the unified vocabulary
are framework-free and are reused from ``cogview_tpu.tokenization``."""
