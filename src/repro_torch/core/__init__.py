"""Population layout, activations, the fused forward, feature selection
and the serving-side reductions (ensembles, selection)."""
