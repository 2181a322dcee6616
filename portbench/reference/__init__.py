"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the package under test and nothing of JAX."""
