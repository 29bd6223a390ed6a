"""The port's optimizer: AdamW over a tree of tensors (``adamw``)."""
