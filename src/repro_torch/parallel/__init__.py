"""Tensor-parallel serving: the sharding rules (``sharding``) and the hint
roles of the model code (``hints``).  Port of the serving half of
``repro.parallel``; the training rules (FSDP/TP, pipeline) are not ported
(ROADMAP.md Queue 1 item 12)."""
