"""repro_torch.launch — the port of ``repro.launch``: the step functions
and abstract inputs (:mod:`.steps`), the production and local meshes
(:mod:`.mesh`), the dry run of every cell on the production mesh
(:mod:`.dryrun`), the training CLI (:mod:`.train`) and the serving CLI
(:mod:`.serve`)."""
