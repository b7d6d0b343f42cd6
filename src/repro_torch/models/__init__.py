"""Models of the port (port of ``repro.models``): the decoder-only LM,
dense and MoE (its training loss and serving path), in ``transformer`` on
the layers of ``layers`` and the experts of ``moe``; the recsys family
(SASRec, DIEN, AutoInt, two-tower retrieval) in ``recsys`` on the sparse
lookups of ``embedding``."""
