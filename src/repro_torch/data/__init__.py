"""Synthetic data substrate (numpy only, shared byte-for-byte with the JAX
package's copy)."""
