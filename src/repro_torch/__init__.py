"""PyTorch/CUDA port of PAL: the committee's serving and training paths
and the LM serving paths (dense, RWKV6, Jamba).

Mirrors the layout of the JAX package ``repro`` (the reference, which this
package never imports): ``kernels`` (committee UQ, flash attention and
WKV6, each a hand-written CUDA kernel for Hopper beside its plain PyTorch
version), ``models`` (the committee MLP potential, ``DenseLM``,
``RWKV6LM``), ``configs``, ``core`` (committee helpers, the fused
acquisition engine, the budget rules, host buffers), ``serving``
(``CommitteeServer``, the microbatching ``ServingQueue``, ``ServeEngine``),
``optim``, ``training``, ``data`` and ``checkpoint`` (the fused committee
trainer and its substrate) and ``launch`` (the serving drivers and
profilers).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
