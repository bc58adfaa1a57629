"""repro_torch.distributed — the port of ``repro.distributed``: the
sharding rules as ``DTensor`` placements (:mod:`.sharding`), elastic
re-placement on a new mesh (:mod:`.elastic`) and the kernels' call sites
on local shards (:mod:`.local`)."""
