"""Parallel attention and model parallelism (port of the reference
`parallel/`): so far the flash kernels' one-device entry."""
