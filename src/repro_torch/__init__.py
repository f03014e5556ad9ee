"""PyTorch/CUDA port of PAL's serving paths: the committee, the dense LM
and the RWKV6 LM.

Mirrors the layout of the JAX package ``repro`` (the reference, which this
package never imports): ``kernels`` (committee UQ, flash attention and
WKV6, each a hand-written CUDA kernel for Hopper beside its plain PyTorch
version), ``models`` (the committee MLP potential, ``DenseLM``,
``RWKV6LM``), ``configs``, ``core`` (committee helpers, the fused
acquisition engine, the budget rules, host buffers), ``serving``
(``CommitteeServer``, the microbatching ``ServingQueue``, ``ServeEngine``)
and ``launch`` (the serving drivers and profilers).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
