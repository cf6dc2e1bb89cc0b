"""L5 — orchestration around the detection core: the offline CSV contract
(``track_detector``) and the live pipeline (``processor``)."""
