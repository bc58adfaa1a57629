"""repro_torch.launch — the port of ``repro.launch``'s training half: the
train step (:mod:`.steps`) and the training CLI (:mod:`.train`).  The
mesh, dry-run and serve launchers belong to the distributed slice."""
