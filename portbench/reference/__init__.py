"""Plain references that decide a cell's ``correct``: fp32 PyTorch for the
train step (:mod:`.transformer`), numpy for the server's sparse fold
(:mod:`.fold`).  They import nothing of the program, of the JAX package or
of JAX, and take only what the benchmark itself made: the configuration
file, the weights and data it drew from the seed.
"""
