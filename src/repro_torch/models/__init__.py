"""Models: the committee MLP potential, the LM zoo's dense and RWKV6
families, and their parameter machinery."""
