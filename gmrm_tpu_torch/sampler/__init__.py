"""Sampler state, distributions, the block scan result and the Gibbs
iteration."""
