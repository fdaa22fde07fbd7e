"""Population layout, activations, the fused forward and the serving-side
reductions (ensembles, selection)."""
