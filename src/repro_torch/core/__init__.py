"""Population layout, activations, the fused forward, feature selection,
the halving lifecycle (``lifecycle``) and the serving-side reductions
(ensembles, selection)."""
