"""repro_torch.launch — the port of ``repro.launch``: the train step
(:mod:`.steps`), the training CLI (:mod:`.train`) and the serving CLI
(:mod:`.serve`).  The mesh and dry-run launchers belong to the
distributed slice."""
