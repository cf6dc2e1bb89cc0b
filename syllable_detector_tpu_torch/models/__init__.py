"""L3 — detection core: the MLP (``neural_net``) and the detector pipeline
(``detector``)."""
