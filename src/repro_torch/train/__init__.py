"""repro_torch.train — the port of ``repro.train``: the deterministic data
pipeline (:mod:`.data`), AdamW with the reference's arithmetic
(:mod:`.optimizer`), int8 error-feedback gradient compression
(:mod:`.compression`), atomic CRC-checked checkpoints (:mod:`.checkpoint`)
and the fault-tolerant loop (:mod:`.train_loop`)."""
