"""Atomic checkpoints of a tree of tensors in the reference's layout
(``ckpt``)."""
