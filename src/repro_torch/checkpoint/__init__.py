"""Layout-carrying population checkpoints, byte-compatible with the JAX
package's on-disk format."""
