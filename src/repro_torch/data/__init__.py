"""The LM's data plane: seeded synthetic analogues of the paper's datasets
(``synth``), the OnPair-compressed corpus store (``corpus``) and the
deterministic token batch pipeline over it (``pipeline``)."""
