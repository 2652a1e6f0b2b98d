"""Plain references the benchmark holds the program's outputs to: a float32
dense decoder and a model of the prefix cache.  They import neither JAX,
the JAX package, nor anything of the program."""
