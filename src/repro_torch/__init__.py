"""repro_torch — the NeoMem serving loop in PyTorch, with hand-written Hopper
kernels.

A port of ``src/repro`` (the JAX reference) for one NVIDIA H100.  The
package keeps the reference's module paths and public layouts so the tests
can hold the two against each other; it imports ``torch`` and ``numpy`` and
nothing of JAX or of the reference package.

Entry points (``ServeEngine``, ``init_params``, ``neoprof_init``,
``tier_init``, ...) run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  On the card every kernel wrapper launches its CUDA
kernel; on the CPU it runs the kernel's plain PyTorch version.
"""
