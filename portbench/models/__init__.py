"""One module per model family: the program's model built from a
configuration's file, and the family's plain reference (``portbench.reference``
holds the blocks both families share). A family module gives ``shape(cfg)``,
``leaf_spec(cfg)``, ``program(cfg, device) -> (model, loss_fn)``,
``program_batch(ids, labels)``, ``step_flops(cfg, traffic)`` and
``Reference(cfg)`` with ``loss_sum(w, ids, labels, mm)`` and
``positions(ids)``."""
