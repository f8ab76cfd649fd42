"""The distributed layer (port of toybox_tpu.parallel): process groups,
the data-parallel layout and the collectives of the sharded learners
(``mesh``), and the multi-rank dry runs (``dryrun``)."""
