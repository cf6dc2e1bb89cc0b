"""L3 — detection core: the MLP (``neural_net``), the detector pipeline
(``detector``) and the batched multi-lane bank (``detector_bank``)."""
