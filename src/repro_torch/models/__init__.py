"""Models of the port beside the population engine: the decoder LM
(``models.lm``), ported from the JAX package's ``repro/models``."""
