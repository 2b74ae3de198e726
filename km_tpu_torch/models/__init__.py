"""The batched catalog pipeline over the torch count table. The rest of
the engine (finder, walk, pathfinder, quant, classify) is km_tpu's."""
