"""Neural-network building blocks of the decoder LMs, ported from the JAX
package's ``repro/nn`` (common layers, rotary embeddings, attention, dense
FFNs and mixtures of experts).  Parameters are plain nested dicts of
tensors; inits return the parameters only (the JAX package's sharding
specs are GSPMD placement and have no counterpart on one card)."""
