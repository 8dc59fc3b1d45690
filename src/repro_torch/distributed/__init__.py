"""Multi-process helpers (the port's copy of the part of
``repro.distributed`` that the campaign executor calls): only
:mod:`.gang`'s ``free_port`` and ``rank_argv``, with which the executor's
gang path spawns one ``run train`` process per rank.  Data-parallel
training itself (``torch.distributed`` ranks, the sharded batches, the
gang launcher ``run_gang_local``) belongs to a later slice; until then a
rank process fails in ``train_main`` (``world_size > 1`` raises) and the
executor records the job ``Failed``.  Importing this package loads
nothing else, so the executor's torch-free scheduler process may."""
