"""Checkpoint IO and weight interop with the JAX package."""
