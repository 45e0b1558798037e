"""Activations, initializers, losses, pooling and the kernel tier."""
