"""L5 — orchestration around the detection core."""
