"""The checker parts of the JAX package's workloads (`workloads/`): the
causal register, long-fork and monotonic-insert checkers, whose
`check()` / `checker()` return the lattice-backed adapters
(`lattice.adapters`).  The generators, clients and the run phase are
not part of the port."""
