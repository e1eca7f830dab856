"""The benchmark's plain reference: what ``correct`` compares the program with.

Plain PyTorch, run on the card in float32 with TF32 off. Each module is a
frozen copy of the function the port computes (its plain versions, which
the port's CPU tests hold to the JAX package), taken when the benchmark was
written so that later changes to the program do not move the yardstick. It
imports neither ``jax`` nor the JAX package nor anything of the port, and
takes nothing the program made: the weights, noise and inputs come from the
benchmark's own seeded makers (:mod:`port_bench.weights`,
:mod:`port_bench.noise`), and the program's outputs are read only to judge
them.
"""
