"""PyTorch/CUDA port of PAL's committee serving path.

Mirrors the layout of the JAX package ``repro`` (the reference, which this
package never imports): ``kernels`` (committee UQ, with a hand-written CUDA
kernel for Hopper and its plain PyTorch version), ``models`` (the committee
MLP potential), ``core`` (committee helpers, the fused acquisition engine,
the budget rules, host buffers) and ``serving`` (``CommitteeServer`` and the
microbatching ``ServingQueue``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
