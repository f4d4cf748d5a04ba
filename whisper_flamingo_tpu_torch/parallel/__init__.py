"""Data and tensor parallelism: the rank bootstrap (:mod:`.distributed`),
the (data, model) rank mesh with the Megatron parameter layout and the
batch split (:mod:`.mesh`), the tensor-parallel collectives inside the
model (:mod:`.tp`) and the multi-rank dry run (:mod:`.dryrun`)."""
