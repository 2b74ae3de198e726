"""The batched catalog pipeline over the torch count table. The host
engine it splices into (table, sequence, finder, walk, pathfinder, quant,
classify) is the port's numpy copy of km_tpu's."""
