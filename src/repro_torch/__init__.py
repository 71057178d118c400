"""repro_torch — the NeoMem serving loop in PyTorch, with hand-written Hopper
kernels.

A port of ``src/repro`` (the JAX reference) for one NVIDIA H100.  The
package keeps the reference's module paths and public layouts so the tests
can hold the two against each other; it imports ``torch`` and ``numpy`` and
nothing of JAX or of the reference package.

It serves all ten of the reference's archs (single-request and lane mode,
the multi-tenant scheduler, unified or with disaggregated prefill,
sampling, the slow-store codecs, content-addressed KV reuse, both data
planes) and trains them, on one device or over a mesh of ranks
(``repro_torch.train.step``, ``repro_torch.dist``, ``repro_torch.launch``).

Entry points (``ServeEngine``, ``init_params``, ``neoprof_init``,
``tier_init``, ``train.step.init_state``, ...) run on ``device="cuda"``
unless the caller passes ``device="cpu"``.  On the card every kernel wrapper launches its CUDA
kernel; on the CPU it runs the kernel's plain PyTorch version.
"""
